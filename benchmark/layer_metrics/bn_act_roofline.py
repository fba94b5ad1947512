"""``bn_act``'s share of its roofline: the bytes inference BatchNorm with
its activation needs (``counts/bn_bytes.py``) at the card's memory
bandwidth, over the device time of the ``bn_act`` kernels in the traced
window."""

KERNELS = ("bn_act_dense_kernel", "bn_act_strided_kernel")


def read(ctx):
    seconds = ctx.trace.kernel_s(KERNELS)
    if ctx.peaks is None or seconds <= 0:
        return None
    return 100.0 * ctx.bn_act_bytes() / ctx.peaks["bytes_per_s"] / seconds
