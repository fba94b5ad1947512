"""Device-idle milliseconds a request while ``run_stream`` is in its
caller's hands: the parts of the port's ``cv:stream.caller`` spans (from
each ``yield`` to the resumption) in which nothing ran on the device, in the
traced window.  The stream dispatches the next batch only when it is
resumed, so this is idle time that the caller's own work puts between
batches."""

from benchmark.harness.trace import gaps

SPAN = "cv:stream.caller"


def read(ctx):
    t = ctx.trace
    lo, hi = t.window
    held = [(max(a, lo), min(b, hi)) for a, b, n in t.host if n == SPAN and a < hi and b > lo]
    if not t.requests or not held:
        return None
    busy = t.busy_intervals()
    idle = sum(g1 - g0 for a, b in held for g0, g1 in gaps(busy, a, b))
    return idle / 1e3 / t.requests
