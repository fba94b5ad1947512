"""FLOPs a board of the whole pipeline, counted from shapes.

``torch.utils.flop_counter.FlopCounterMode`` over the reference pipeline
on zero frames of the cell's size: every convolution, transposed
convolution, matmul and linear layer it dispatches (both models, both
classifier passes, the resize's matmuls where a frame is not a power-of-two
multiple of the segmenter's input, the quadrangle's projections, the
homographies, the grid comb and the correction), each kernel tap counted as
an implicit GEMM computes it, padding included.  The program dispatches the
same products at the same shapes (the port's ``tools/flops.py:
pipeline_flops_per_board`` counts the same on 512² frames); the warp is a
gather and counts no FLOP.  Every stage is branch-free over the data, so
zeros cost what any frames cost."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def pipeline_flops_per_board(reference, h: int, w: int, n: int = 2) -> float:
    """FLOPs a board of ``reference.run`` on ``n`` zero (h, w) frames."""
    frames = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=reference.device)
    counter = FlopCounterMode(display=False)
    with counter:
        reference.run(frames)
    return float(counter.get_total_flops()) / n
