"""Area/bilinear resize on tensors.

Counterpart of ``chessvision_tpu/ops/resize.py``: cv2.INTER_AREA semantics
for downscales (exact box-overlap weights), bilinear with half-pixel
centers for upscales.  Two paths:

- integer-factor downscale with a power-of-two box (the 512→256 case of
  the main path): reshape + sum + one exact power-of-two scale;
- otherwise two float32 matmuls against per-axis weight matrices.  On the
  GPU the caller runs this with TF32 off (``utils.full_f32``), so the
  products keep full float32 as the JAX package's HIGHEST precision does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chessvision_tpu_torch.ops.color import round_u8


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) box-overlap weight matrix for area downscaling."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float32)
    for o in range(dst):
        start = o * scale
        end = (o + 1) * scale
        for s in range(int(np.floor(start)), min(int(np.ceil(end)), src)):
            overlap = min(end, s + 1) - max(start, s)
            if overlap > 0:
                w[o, s] = overlap / scale
    return w


def _bilinear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weight matrix with half-pixel centers."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float32)
    for o in range(dst):
        x = (o + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        w[o, min(max(x0, 0), src - 1)] += 1.0 - frac
        w[o, min(max(x0 + 1, 0), src - 1)] += frac
    return w


@lru_cache(maxsize=64)
def resize_matrices(src_h: int, src_w: int, dst_h: int, dst_w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis weights (W_h: (dst_h, src_h), W_w: (dst_w, src_w)): area on a
    shrinking axis, bilinear otherwise."""
    wh = _area_weights(src_h, dst_h) if dst_h < src_h else _bilinear_weights(src_h, dst_h)
    ww = _area_weights(src_w, dst_w) if dst_w < src_w else _bilinear_weights(src_w, dst_w)
    return wh, ww


def resize(img: torch.Tensor, dst_hw: tuple[int, int], *, round_uint8: bool = False) -> torch.Tensor:
    """Resize image(s) to ``dst_hw = (height, width)`` in float32;
    ``round_uint8`` rounds half up and returns uint8.  Takes (H, W),
    (H, W, C), (B, H, W) or (B, H, W, C); a 3-D input whose last axis is
    at most 4 long is (H, W, C), as in the JAX package."""
    if img.ndim == 2:
        return resize(img[None, :, :, None], dst_hw, round_uint8=round_uint8)[0, :, :, 0]
    if img.ndim == 3 and img.shape[-1] <= 4:
        return resize(img[None], dst_hw, round_uint8=round_uint8)[0]
    if img.ndim == 3:
        return resize(img[..., None], dst_hw, round_uint8=round_uint8)[..., 0]
    dst_h, dst_w = dst_hw
    b, src_h, src_w, c = img.shape
    fh, fw = src_h // max(dst_h, 1), src_w // max(dst_w, 1)
    box = fh * fw
    if (
        dst_h < src_h
        and dst_w < src_w
        and src_h % dst_h == 0
        and src_w % dst_w == 0
        and box & (box - 1) == 0
    ):
        # ≤2^16-term integer sums and a 2^-k scale: exact in float32
        out = img.float().reshape(b, dst_h, fh, dst_w, fw, c).sum(dim=(2, 4)) * (1.0 / box)
    else:
        wh, ww = resize_matrices(src_h, src_w, dst_h, dst_w)
        wh_t = torch.from_numpy(wh).to(img.device)
        ww_t = torch.from_numpy(ww).to(img.device)
        out = torch.einsum("hs,bswc->bhwc", wh_t, img.float())
        out = torch.einsum("wt,bhtc->bhwc", ww_t, out)
    return round_u8(out) if round_uint8 else out
