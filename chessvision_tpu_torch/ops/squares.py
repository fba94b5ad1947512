"""8×8 square slicing of rectified boards (counterpart of
``chessvision_tpu/ops/squares.py``): rank-major, a8 first in normal
orientation."""

from __future__ import annotations

import torch


def extract_squares_batch(boards: torch.Tensor) -> torch.Tensor:
    """(B, H, W) boards → (B, 64, H//8, W//8, 1) squares."""
    b, h, w = boards.shape
    sh, sw = h // 8, w // 8
    squares = boards.reshape(b, 8, sh, 8, sw).permute(0, 1, 3, 2, 4)
    return squares.reshape(b, 64, sh, sw, 1)
