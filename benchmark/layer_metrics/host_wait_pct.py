"""Percent of the traced window in which the host waits for the device: the
port's ``cv:device_wait`` spans (the engine waits for its stream before it
copies the outputs back) inside the window, over the window."""

from benchmark.harness.trace import covered, union

SPAN = "cv:device_wait"


def read(ctx):
    t = ctx.trace
    waits = union((a, b) for a, b, n in t.host if n == SPAN)
    if t.window_s <= 0 or not waits:
        return None
    lo, hi = t.window
    return 100.0 * covered(waits, lo, hi) / (hi - lo)
