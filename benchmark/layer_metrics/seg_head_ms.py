"""Host milliseconds a request in a segment head's decode, top-1 and mask
assembly: the port's ``cv:seg_head`` spans in the traced window (none in a
program or a model without that head)."""

SPAN = "cv:seg_head"


def read(ctx):
    t = ctx.trace
    lo, hi = t.window
    spans = [(a, b) for a, b, n in t.host if n == SPAN and lo <= a < hi]
    if not t.requests or not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / t.requests
