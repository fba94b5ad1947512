"""Host milliseconds a request in the engine's copy of the outputs back to
the host, without the wait for the device before it: the port's
``cv:copy_back`` spans less their ``cv:device_wait`` children, in the
traced window."""

COPY, WAIT = "cv:copy_back", "cv:device_wait"


def read(ctx):
    t = ctx.trace
    lo, hi = t.window
    copies = [(a, b) for a, b, n in t.host if n == COPY and lo <= a < hi]
    if not t.requests or not copies:
        return None
    waits = [(a, b) for a, b, n in t.host if n == WAIT and any(c <= a and b <= d for c, d in copies)]
    us = sum(b - a for a, b in copies) - sum(b - a for a, b in waits)
    return us / 1e3 / t.requests
