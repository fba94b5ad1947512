"""Host milliseconds a request in the segmenter: the port's ``cv:extractor``
spans in the traced window (the forward's launches and, where the model
has one, its ``cv:seg_head`` inside)."""

SPAN = "cv:extractor"


def read(ctx):
    t = ctx.trace
    lo, hi = t.window
    spans = [(a, b) for a, b, n in t.host if n == SPAN and lo <= a < hi]
    if not t.requests or not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / t.requests
