"""The bytes floor of K1, the warp into the margin canvas.

A warp that reads only what its outputs depend on moves, per board, the
32-byte sectors of the float32 gray frame under its nonzero taps (the rows
of pass 2's taps, and in each such row the columns of pass 1's taps), and
writes the canvas once.  Frozen from the port's ``tools/flops.py:
tap_sector_bytes`` arithmetic, on the positions that the reference derives
from the homographies of its own quadrangles; so the floor is the same
whichever kernel, or route, runs the warp."""

from __future__ import annotations

import torch

from benchmark.reference import ops


def tap_sector_bytes(shape: tuple[int, int, int], hx: torch.Tensor, vy: torch.Tensor) -> int:
    """Bytes of the distinct 32-byte sectors of a float32 (B, H, W) image,
    aligned at 0, that the taps at ``hx`` (B, H, out_w) and ``vy`` (B, out_w,
    out_h) read."""
    b, h, w = shape
    n = torch.arange(b, device=vy.device)[:, None, None].expand_as(vy)
    u = torch.arange(vy.shape[1], device=vy.device)[None, :, None].expand_as(vy)
    sectors = []
    for dr in (0, 1):
        r = torch.floor(vy) + dr
        ok = (r >= 0) & (r < h) & (1.0 - torch.abs(vy - r) > 0)
        nn_, rr, uu = n[ok], r[ok].long(), u[ok]
        p = hx[nn_, rr, uu]
        for dc in (0, 1):
            c = torch.floor(p) + dc
            okc = (c >= 0) & (c < w) & (1.0 - torch.abs(p - c) > 0)
            flat = (nn_[okc] * h + rr[okc]) * w + c[okc].long()
            sectors.append(torch.unique((4 * flat) // 32))
    return 32 * int(torch.unique(torch.cat(sectors)).numel())


def warp_floor_bytes(frame_hw: tuple[int, int], ms_wide: torch.Tensor, canvas: int) -> int:
    """Floor bytes of warping frames of ``frame_hw`` by the (B, 3, 3)
    homographies ``ms_wide`` into ``canvas``² float32 canvases, one board
    at a time."""
    h, w = frame_hw
    total = 0
    for i in range(len(ms_wide)):
        minv = ops.invert_homography(ms_wide[i : i + 1].float())
        hx, vy = ops.twopass_positions(minv, h, canvas, canvas)
        total += tap_sector_bytes((1, h, w), hx, vy) + canvas * canvas * 4
    return total
