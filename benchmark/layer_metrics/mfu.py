"""The whole pipeline's share of the card's dense bf16 peak: the FLOPs a
board (``counts/flops.py``) times the boards of the traced window, over
its seconds."""


def read(ctx):
    t = ctx.trace
    if ctx.peaks is None or t.window_s <= 0 or not t.boards:
        return None
    return 100.0 * ctx.flops_per_board() * t.boards / t.window_s / ctx.peaks["bf16_flop_per_s"]
