"""Percent of the host-to-device copy time that lies under kernels in the
traced window: how much of the stream's upload is hidden."""


def read(ctx):
    return ctx.trace.h2d_under_kernels_pct()
