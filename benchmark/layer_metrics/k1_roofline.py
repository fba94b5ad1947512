"""K1's share of its roofline: the least time the warp into the margin
canvas could take, its bytes floor (``counts/k1_bytes.py``) at the card's
memory bandwidth, over the device time of the warp kernels in the traced
window.  The floor is bound by bytes: the warp does two FMAs a tap."""

KERNELS = ("warp_pass1_kernel", "warp_pass2_kernel", "warp_fused_kernel")


def read(ctx):
    seconds = ctx.trace.kernel_s(KERNELS)
    if ctx.peaks is None or seconds <= 0:
        return None
    return 100.0 * ctx.k1_floor_bytes() / ctx.peaks["bytes_per_s"] / seconds
