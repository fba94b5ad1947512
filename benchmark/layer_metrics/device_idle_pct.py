"""Percent of the traced window in which nothing ran on the device: no
kernel, copy or fill on any stream (the union of their intervals, so two
streams' overlap counts once)."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not (t.kernels or t.copies):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
