"""Non-finite inputs of K1's warp, on the CPU and on the card
(``tests/test_torch_warp_fused.py``, ``tests/test_torch_cuda.py``): each
case is a batch of two boards, the first carrying the fault, the second
an ordinary rotated board.  Imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from chessvision_tpu_torch.ops import hat_resample, warp

NONFINITE = ("nan_homography", "inf_entry", "collinear_quad", "inf_pixel")
SRC, CANVAS = 48, 40
# (row, column): inside the board, off row 0 and column 0, which warp_fused_plain's
# outside taps read at weight 0 (0 · inf is NaN) where the card's select gives 0
BAD_PIXEL = (17, 23)


def _minv(quad: np.ndarray) -> torch.Tensor:
    """The inverse homography taking the canvas onto ``quad`` in the frame."""
    dest = torch.tensor([[0, 0], [CANVAS, 0], [CANVAS, CANVAS], [0, CANVAS]], dtype=torch.float32)
    return warp.invert_homography(warp.get_perspective_transform(torch.tensor(quad, dtype=torch.float32), dest))


def _rotated(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * 15 @ rot.T + 24


def nonfinite_case(name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(imgs (2, SRC, SRC), minv (2, 3, 3)) on the CPU, made from a seed."""
    rng = np.random.default_rng(NONFINITE.index(name))
    imgs = torch.from_numpy(rng.integers(0, 256, (2, SRC, SRC)).astype(np.float32))
    minv = torch.stack([_minv(_rotated(20)), _minv(_rotated(-12))])
    if name == "nan_homography":
        minv[0] = float("nan")
    elif name == "inf_entry":  # i = inf: every pass-1 position is inf/inf or 0·inf
        minv[0, 2, 2] = float("inf")
    elif name == "collinear_quad":  # three corners on one line: a singular homography
        minv[0] = _minv(np.array([[5, 5], [20, 20], [35, 35], [5, 40]], np.float64))
    else:
        imgs[0][BAD_PIXEL] = float("inf")
    return imgs, minv


def taps_pixel(minv: torch.Tensor, out_h: int, out_w: int, pixel: tuple[int, int]) -> np.ndarray:
    """(B, out_h, out_w): whether an output has ``pixel`` among the source
    taps it reads, by K1's tap rule (the rows floor(vy), floor(vy) + 1 inside
    the frame, and in each the columns floor(hx), floor(hx) + 1 inside)."""
    hx, vy = (p.numpy() for p in hat_resample.twopass_positions(minv, SRC, out_h, out_w))
    y, x = pixel
    hit = np.zeros((len(minv), out_h, out_w), bool)
    for b, v, u in np.ndindex(*hit.shape):
        for r in (np.floor(vy[b, u, v]), np.floor(vy[b, u, v]) + 1):
            if r == y and -1 < vy[b, u, v] < SRC:
                p = hx[b, y, u]
                hit[b, v, u] |= -1 < p < SRC and x in (np.floor(p), np.floor(p) + 1)
    return hit
