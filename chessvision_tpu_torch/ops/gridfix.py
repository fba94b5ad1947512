"""Grid-line refinement of warped boards.

Counterpart of ``chessvision_tpu/ops/gridfix.py``: detect the 8×8 grid
inside a warped board from its edge-energy profiles (smoothing, median
subtraction, sqrt, then a comb matmul over 129 offsets × 49 spacings and
an argmax), and resample the board so the detected grid lands on the
ideal one.  The comb and candidate tables are built in numpy exactly as
there.  Float32 matmuls here run with TF32 off (``utils.full_f32``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from chessvision_tpu_torch.ops.warp import invert_homography

BOARD_SIZE = 512
CELL = 64

_OFFSETS = np.arange(-32.0, 32.5, 0.5, dtype=np.float32)  # 129
_SPACINGS = np.arange(58.0, 70.25, 0.25, dtype=np.float32)  # 49
_CAND = np.array([(o, s) for o in _OFFSETS for s in _SPACINGS], dtype=np.float32)  # (C, 2)


def _build_comb() -> np.ndarray:
    """(C, 512) hat-interpolation comb: W[c, x] = Σ_k hat(x − (o_c + k·s_c)),
    k = 1..7 (the interior lines)."""
    xs = np.arange(BOARD_SIZE, dtype=np.float32)
    lines = _CAND[:, 0:1] + _CAND[:, 1:2] * np.arange(1, 8, dtype=np.float32)  # (C, 7)
    w = np.zeros((len(_CAND), BOARD_SIZE), np.float32)
    for chunk in range(0, len(_CAND), 512):
        sl = slice(chunk, chunk + 512)
        d = np.maximum(0.0, 1.0 - np.abs(xs[None, None, :] - lines[sl, :, None]))
        w[sl] = d.sum(axis=1)
    return w


_COMB = _build_comb()
_TRI = (np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32) / 9.0).tolist()


@lru_cache(maxsize=8)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(comb.T (512, C), candidates (C, 2)) on ``device``, copied once."""
    return torch.from_numpy(_COMB.T.copy()).to(device), torch.from_numpy(_CAND).to(device)


def _profiles(boards: torch.Tensor) -> torch.Tensor:
    """(B, 512, 512) → (2B, 512) edge-energy profiles: column profiles
    (vertical lines) first, then row profiles."""
    gx = torch.abs(boards[:, :, 1:] - boards[:, :, :-1])
    gy = torch.abs(boards[:, 1:, :] - boards[:, :-1, :])
    col = torch.nn.functional.pad(gx.sum(dim=1), (0, 1))
    row = torch.nn.functional.pad(gy.sum(dim=2), (0, 1))
    return torch.cat([col, row], dim=0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as numpy/JAX define it: the mean of the two
    middle values for an even count (``torch.median`` returns the lower)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    if n % 2:
        return s[..., n // 2 : n // 2 + 1]
    return (s[..., n // 2 - 1 : n // 2] + s[..., n // 2 : n // 2 + 1]) * 0.5


def _condition(p: torch.Tensor) -> torch.Tensor:
    """5-tap triangle smoothing, median subtraction, sqrt."""
    sm = torch.zeros_like(p)
    for i, w in enumerate(_TRI):
        sh = i - 2
        if sh < 0:
            sm[:, :sh] = sm[:, :sh] + w * p[:, -sh:]
        elif sh > 0:
            sm[:, sh:] = sm[:, sh:] + w * p[:, :-sh]
        else:
            sm = sm + w * p
    sm = torch.clamp_min(sm - _median(sm), 0.0)
    return torch.sqrt(sm)


def detect_grid(boards: torch.Tensor) -> torch.Tensor:
    """(B, 512, 512) float32 boards (pass the uint8-rounded board) → (B, 4)
    rows ``(ox, sx, oy, sy)``: detected line k of an axis sits at o + k·s."""
    b = boards.shape[0]
    p = _condition(_profiles(boards.float()))  # (2B, 512)
    comb_t, cand = _tables(p.device)
    best = torch.argmax(p @ comb_t, dim=-1)  # (2B,)
    osel = cand[best]  # (2B, 2)
    return torch.cat([osel[:b], osel[b:]], dim=1)


def _axis_resample_matrix(o: torch.Tensor, s: torch.Tensor, src_size: int, shift: float) -> torch.Tensor:
    """(B, 512, src_size) hat-resample matrices R[b, u, j] =
    hat(shift + o_b + u·s_b/64 − j), rounded to bf16 values (exact: the
    weights are multiples of 2^-8) and held as float32."""
    u = torch.arange(BOARD_SIZE, dtype=torch.float32, device=o.device)
    pos = (shift + o)[:, None] + u[None, :] * (s / CELL)[:, None]
    j = torch.arange(src_size, dtype=torch.float32, device=o.device)
    w = torch.clamp_min(1.0 - torch.abs(pos[:, :, None] - j[None, None, :]), 0.0)
    return w.to(torch.bfloat16).float()


def apply_correction(boards: torch.Tensor, corr: torch.Tensor, margin: int = 0) -> torch.Tensor:
    """Resample (B, 512 + 2m, 512 + 2m) boards into corrected (B, 512, 512)
    boards by (B, 4) corrections.  As in the JAX package, the operands are
    rounded to bf16 and the products are accumulated in float32: here as
    float32 matmuls of bf16-rounded values, so each output (a sum of ≤ 2
    exact products per pass) matches bit for bit."""
    src = BOARD_SIZE + 2 * margin
    rx = _axis_resample_matrix(corr[:, 0], corr[:, 1], src, float(margin))  # (B, 512, src)
    ry = _axis_resample_matrix(corr[:, 2], corr[:, 3], src, float(margin))
    b16 = boards.to(torch.bfloat16).float()
    t = torch.bmm(b16, rx.transpose(1, 2))  # (B, src(i), 512(u))
    return torch.bmm(ry, t.to(torch.bfloat16).float())  # (B, 512(v), 512(u))


def refined_quadrangle(ms: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Image-space corners (B, 4, 2) of the corrected board: M⁻¹ applied to
    the corrected ideal corners, in the engine's destination order."""
    minv = invert_homography(ms)
    dev = corr.device
    cx = torch.tensor([0.0, BOARD_SIZE, BOARD_SIZE, 0.0], dtype=torch.float32, device=dev)
    cy = torch.tensor([0.0, 0.0, BOARD_SIZE, BOARD_SIZE], dtype=torch.float32, device=dev)
    ax = corr[:, 0:1] + cx[None, :] * (corr[:, 1:2] / CELL)
    ay = corr[:, 2:3] + cy[None, :] * (corr[:, 3:4] / CELL)
    pts = torch.stack([ax, ay, torch.ones_like(ax)], dim=1)  # (B, 3, 4)
    img = torch.bmm(minv, pts)
    return (img[:, :2] / img[:, 2:3]).transpose(1, 2)
