"""Host milliseconds a request in the engine's upload of its inputs to the
device: the port's ``cv:upload`` spans in the traced window."""

SPAN = "cv:upload"


def read(ctx):
    t = ctx.trace
    lo, hi = t.window
    uploads = [(a, b) for a, b, n in t.host if n == SPAN and lo <= a < hi]
    if not t.requests or not uploads:
        return None
    return sum(b - a for a, b in uploads) / 1e3 / t.requests
