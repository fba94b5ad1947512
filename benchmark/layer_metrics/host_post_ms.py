"""Host milliseconds a batch in the engine's host side after the copy back:
the threshold mask, the chess-rule validation and the FEN strings, from the
harness's spans around them in the traced window (no synchronisation is
added)."""


def read(ctx):
    t = ctx.trace
    if not t.requests:
        return None
    seconds = sum(t.span_s(label) for label in ("mask", "validate", "fen"))
    return 1e3 * seconds / t.requests if seconds > 0 else None
