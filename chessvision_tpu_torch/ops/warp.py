"""Perspective transform: closed-form homography and projective warps.

Counterpart of ``chessvision_tpu/ops/warp.py``, batched over boards:

- ``get_perspective_transform`` and ``invert_homography`` in the same
  closed-form adjugate algebra (no linear solve);
- ``warp_perspective`` with ``method="twopass"`` (the main path: the
  Catmull–Smith two-pass warp, which is kernel K1's ``warp_twopass`` in
  ``ops/hat_resample.py``: on the CPU the tap gather ``warp_fused_plain``,
  K1's tap rule as both card routes compute it; the dense plain version
  of the two-pass kernels, ``warp_twopass_plain``, and
  ``twopass_positions`` live beside the kernel's wrapper and are
  re-exported here) or ``method="bilinear"`` (one-shot bilinear gather,
  cv2.warpPerspective arithmetic).
"""

from __future__ import annotations

import torch

from chessvision_tpu_torch.ops import hat_resample as _k1
from chessvision_tpu_torch.ops.color import round_u8
from chessvision_tpu_torch.ops.hat_resample import twopass_positions, warp_twopass_plain  # noqa: F401  (re-exported)


def _adjugate(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → adjugate (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    rows = [
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _basis_homography(pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) points → homography mapping the projective basis e1, e2,
    e3, (1,1,1) to them: columns p1 p2 p3 scaled by adj(m)·p4."""
    ones = torch.ones_like(pts[..., :3, 0])
    m = torch.stack([pts[..., :3, 0], pts[..., :3, 1], ones], dim=-2)  # (..., 3, 3)
    p4 = torch.stack([pts[..., 3, 0], pts[..., 3, 1], ones[..., 0]], dim=-1)
    scale = (_adjugate(m) @ p4[..., None])[..., 0]
    return m * scale[..., None, :]


def get_perspective_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Homographies (..., 3, 3) mapping src[i] → dst[i] for 4 point pairs,
    normalized so M[2, 2] = 1 (cv2.getPerspectiveTransform's result)."""
    src = src.float()
    dst = dst.float()
    m = _basis_homography(dst) @ _adjugate(_basis_homography(src))
    return m / m[..., 2:3, 2:3]


def invert_homography(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse via the adjugate."""
    adj = _adjugate(m)
    det = m[..., 0, 0] * adj[..., 0, 0] + m[..., 0, 1] * adj[..., 1, 0] + m[..., 0, 2] * adj[..., 2, 0]
    return adj / det[..., None, None]


def _warp_batched_twopass(imgs: torch.Tensor, ms: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Catmull–Smith two-pass warp of (B, H, W) by (B, 3, 3) src→dst
    homographies.  Pass 1 resamples each source row y at hx(u, y) = X(u, v*)
    where Y(u, v*) = y; pass 2 resamples each column of the result at
    Y(u, v).  Accurate for rotations up to roughly ±45°, which the
    engine's corner ordering guarantees."""
    return _k1.warp_twopass(imgs, invert_homography(ms), out_h, out_w)


def _warp_batched(imgs: torch.Tensor, ms: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """One-shot bilinear warp with zero border (cv2.warpPerspective): dst
    pixel (x, y) samples src at M⁻¹·(x, y, 1) by a gather of 4 taps."""
    b, src_h, src_w = imgs.shape
    dev = imgs.device
    mi = invert_homography(ms)[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None].expand(out_h, out_w)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(out_h, out_w)
    denom = mi[:, 2, 0] * xs + mi[:, 2, 1] * ys + mi[:, 2, 2]
    sx = (mi[:, 0, 0] * xs + mi[:, 0, 1] * ys + mi[:, 0, 2]) / denom
    sy = (mi[:, 1, 0] * xs + mi[:, 1, 1] * ys + mi[:, 1, 2]) / denom
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = imgs.reshape(b, src_h * src_w)
    out = torch.zeros((b, out_h, out_w), dtype=torch.float32, device=dev)
    taps = [
        ((0, 0), (1.0 - fx) * (1.0 - fy)),
        ((0, 1), fx * (1.0 - fy)),
        ((1, 0), (1.0 - fx) * fy),
        ((1, 1), fx * fy),
    ]
    for (dy, dx), w in taps:
        yi = y0i + dy
        xi = x0i + dx
        valid = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h)
        fidx = torch.clamp(yi, 0, src_h - 1) * src_w + torch.clamp(xi, 0, src_w - 1)
        v = torch.gather(flat, 1, fidx.reshape(b, -1)).reshape(b, out_h, out_w)
        out = out + torch.where(valid, v, torch.zeros_like(v)) * w
    return out


def warp_perspective(
    img: torch.Tensor,
    m: torch.Tensor,
    out_size: tuple[int, int],
    *,
    round_uint8: bool = False,
    method: str = "twopass",
) -> torch.Tensor:
    """Warp (H, W) with a (3, 3) homography, or (B, H, W) with (B, 3, 3),
    to ``out_size = (width, height)``; float32, optional uint8 rounding."""
    out_w, out_h = out_size
    imgf = img.float()
    mf = m.float()
    single = imgf.ndim == 2
    if single:
        imgf, mf = imgf[None], mf[None]
    if method == "twopass":
        out = _warp_batched_twopass(imgf, mf, out_h, out_w)
    elif method == "bilinear":
        out = _warp_batched(imgf, mf, out_h, out_w)
    else:
        raise ValueError(f"unknown warp method {method!r}")
    if single:
        out = out[0]
    return round_u8(out) if round_uint8 else out
