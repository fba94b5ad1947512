"""CUDA launch calls a request on the host (kernel and graph launches) in
the traced window."""


def read(ctx):
    t = ctx.trace
    if not t.requests or not t.launches:
        return None
    return t.launches / t.requests
