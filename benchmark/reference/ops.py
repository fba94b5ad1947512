"""Plain PyTorch image stages of the reference pipeline, in float32.

Frozen copies of the plain versions of the port's stages, so that a later
change to the port cannot move what the benchmark compares against:
exact fixed-point gray and area resize, the batched quadrangle finder,
the closed-form homographies, the hat warp (two-pass and fused orders),
the grid detection and correction, and the square slicing.  No kernel,
no cache, no batching beyond the tensors' own batch axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INPUT_HW = (256, 256)
BOARD = 512
CELL = 64

# -- colour and resize -------------------------------------------------------

_R_COEF, _G_COEF, _B_COEF, _SHIFT = 9798, 19235, 3735, 15


def bgr_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR → (..., H, W) uint8, cv2's fixed-point gray."""
    b, g, r = (img[..., i].to(torch.int32) for i in range(3))
    acc = r * _R_COEF + g * _G_COEF + b * _B_COEF + (1 << (_SHIFT - 1))
    return (acc >> _SHIFT).to(torch.uint8)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) clipped to [0, 255], as uint8."""
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Flip (B, H, W) along W."""
    return torch.flip(img, dims=(img.ndim - 1,))


def _area_weights(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float32)
    for o in range(dst):
        start, end = o * scale, (o + 1) * scale
        for s in range(int(np.floor(start)), min(int(np.ceil(end)), src)):
            overlap = min(end, s + 1) - max(start, s)
            if overlap > 0:
                w[o, s] = overlap / scale
    return w


def resize_area(img: torch.Tensor, dst_hw: tuple[int, int] = INPUT_HW) -> torch.Tensor:
    """(B, H, W, C) downscale to ``dst_hw`` with cv2.INTER_AREA weights, in
    float32: an exact box mean for power-of-two integer factors, else two
    matmuls against the box-overlap matrices (TF32 off on the caller)."""
    dst_h, dst_w = dst_hw
    b, src_h, src_w, c = img.shape
    fh, fw = src_h // dst_h, src_w // dst_w
    box = fh * fw
    if src_h % dst_h == 0 and src_w % dst_w == 0 and box & (box - 1) == 0:
        return img.float().reshape(b, dst_h, fh, dst_w, fw, c).sum(dim=(2, 4)) * (1.0 / box)
    wh = torch.from_numpy(_area_weights(src_h, dst_h)).to(img.device)
    ww = torch.from_numpy(_area_weights(src_w, dst_w)).to(img.device)
    out = torch.einsum("hs,bswc->bhwc", wh, img.float())
    return torch.einsum("wt,bhtc->bhwc", ww, out)


# -- quadrangle ---------------------------------------------------------------

NUM_DIRECTIONS = 64
FLOOD_ROUNDS = 3


def _flood_pass_rows(mask: torch.Tensor, visited: torch.Tensor, run_id: torch.Tensor) -> torch.Tensor:
    vj = (mask & visited).to(torch.int32)
    has = torch.zeros((*run_id.shape[:-1], run_id.shape[-1] + 1), dtype=torch.int32, device=run_id.device)
    has.scatter_add_(-1, run_id, vj)
    return visited | (mask & (torch.gather(has, -1, run_id) > 0))


def _component(mask: torch.Tensor, seed_flat: torch.Tensor) -> torch.Tensor:
    b, h, w = mask.shape
    visited = torch.zeros((b, h * w), dtype=torch.bool, device=mask.device)
    visited[torch.arange(b, device=mask.device), seed_flat] = True
    visited = visited.reshape(b, h, w) & mask
    mask_t = mask.transpose(1, 2)
    run_rows = torch.cumsum((~mask).to(torch.int64), dim=-1)
    run_cols = torch.cumsum((~mask_t).to(torch.int64), dim=-1)
    for _ in range(FLOOD_ROUNDS):
        visited = _flood_pass_rows(mask, visited, run_rows)
        visited = _flood_pass_rows(mask_t, visited.transpose(1, 2), run_cols).transpose(1, 2)
    return visited


def _support_points(comp: torch.Tensor, k: int = NUM_DIRECTIONS) -> torch.Tensor:
    b, h, w = comp.shape
    dev = comp.device
    xs = torch.arange(w, dtype=torch.int32, device=dev).expand(b, h, w)
    big = 1 << 20
    min_x = torch.where(comp, xs, big).amin(dim=2)
    max_x = torch.where(comp, xs, -big).amax(dim=2)
    row_valid = comp.any(dim=2)
    ys = torch.arange(h, dtype=torch.float32, device=dev).expand(b, h)
    cand = torch.cat([torch.stack([min_x.float(), ys], dim=2), torch.stack([max_x.float(), ys], dim=2)], dim=1)
    valid = torch.cat([row_valid, row_valid], dim=1)
    thetas = torch.arange(k, dtype=torch.float32, device=dev) * (2.0 * math.pi / k)
    dirs = torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=0)
    proj = torch.where(valid[:, :, None], cand @ dirs, -3.0e8)
    idx = torch.argmax(proj, dim=1)
    return torch.gather(cand, 1, idx[:, :, None].expand(b, k, 2))


def _decimate(points: torch.Tensor) -> torch.Tensor:
    b, k, _ = points.shape
    dev = points.device
    idx = torch.arange(k, device=dev)
    rows = torch.arange(b, device=dev)
    prv = torch.roll(idx, 1).expand(b, k).clone()
    nxt = torch.roll(idx, -1).expand(b, k).clone()
    active = torch.ones((b, k), dtype=torch.bool, device=dev)
    tie = idx.to(torch.float32) * 1e-6
    px, py = points[..., 0], points[..., 1]
    for _ in range(k - 4):
        ax, ay = torch.gather(px, 1, prv), torch.gather(py, 1, prv)
        cx, cy = torch.gather(px, 1, nxt), torch.gather(py, 1, nxt)
        cross = torch.abs((ax - px) * (cy - py) - (ay - py) * (cx - px))
        chord = torch.sqrt((cx - ax) ** 2 + (cy - ay) ** 2)
        devs = torch.where(active, cross / torch.clamp_min(chord, 1e-6) + tie, 3.0e18)
        r = torch.argmin(devs, dim=1)
        pr, nx = prv[rows, r], nxt[rows, r]
        active[rows, r] = False
        nxt[rows, pr] = nx
        prv[rows, nx] = pr
    i0 = torch.argmax(active.to(torch.int32), dim=1)
    i1 = nxt[rows, i0]
    i2 = nxt[rows, i1]
    i3 = nxt[rows, i2]
    sel = torch.stack([i0, i1, i2, i3], dim=1)
    return torch.gather(points, 1, sel[:, :, None].expand(b, 4, 2))


def _order(quad: torch.Tensor) -> torch.Tensor:
    b = quad.shape[0]
    q = torch.flip(quad, dims=(1,))
    start = torch.argmin(q[..., 1] * 4096.0 + q[..., 0], dim=1)
    idx = (torch.arange(4, device=quad.device)[None, :] + start[:, None]) % 4
    q = torch.gather(q, 1, idx[:, :, None].expand(b, 4, 2))
    return torch.where((q[:, 0, 0] < q[:, 2, 0])[:, None, None], q[:, [3, 0, 1, 2]], q)


def _shoelace(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.abs(torch.sum(x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y, dim=-1))


def find_quadrangles(probs: torch.Tensor, threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) probabilities → (quads (B, 4, 2) in mask pixels, found (B,)):
    the seeded dominant component's hull decimated to four corners, and the
    area, ratio, small-board, fit and convexity gates."""
    probs = probs.float()
    b, h, w = probs.shape
    dev = probs.device
    mask = probs > threshold
    box = torch.ones((1, 1, 9, 9), dtype=torch.float32, device=dev)
    smoothed = F.conv2d(probs[:, None], box, padding=4)[:, 0]
    seed = torch.argmax(torch.where(mask, smoothed, -1.0).reshape(b, h * w), dim=1)
    mask_small = mask.reshape(b, h // 2, 2, w // 2, 2).any(dim=4).any(dim=2)
    seed_small = (seed // w // 2) * (w // 2) + (seed % w) // 2
    comp_small = _component(mask_small, seed_small)
    comp = comp_small.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) & mask
    area = comp.sum(dim=(1, 2), dtype=torch.float32)
    foreground = mask.sum(dim=(1, 2), dtype=torch.float32)
    frac = area / float(h * w)
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(b, h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(b, h, w)
    big = 1 << 30
    bb_w = (torch.where(comp, xs, -big).amax(dim=(1, 2)) - torch.where(comp, xs, big).amin(dim=(1, 2)) + 1).float()
    bb_h = (torch.where(comp, ys, -big).amax(dim=(1, 2)) - torch.where(comp, ys, big).amin(dim=(1, 2)) + 1).float()
    ratio = torch.minimum(bb_w, bb_h) / torch.clamp_min(torch.maximum(bb_w, bb_h), 1.0)
    pts = _support_points(comp)
    quad = _order(_decimate(pts))
    quad_area = _shoelace(quad[..., 0], quad[..., 1])
    hull_area = _shoelace(pts[..., 0], pts[..., 1])
    filters = (frac >= 0.35) & (frac <= 1.0) & (ratio >= 0.6)
    small_ok = (area >= 0.95 * foreground) & (frac >= 0.05) & (ratio >= 0.6) & (area >= 0.85 * hull_area)
    found = torch.where(area < foreground, filters | small_ok, True) & (quad_area <= 1.45 * area) & (area > 0)
    return quad.float(), found


def scale_quadrangle(quad: torch.Tensor, orig_h: int, mask_h: int = INPUT_HW[0]) -> torch.Tensor:
    """Mask pixels → frame pixels; both axes by the height ratio."""
    sf = torch.tensor(float(orig_h), dtype=torch.float32) / torch.tensor(float(mask_h), dtype=torch.float32)
    return quad * sf.to(quad.device)


# -- homographies and the hat warp ----------------------------------------------


def _adjugate(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    rows = [
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _basis(pts: torch.Tensor) -> torch.Tensor:
    ones = torch.ones_like(pts[..., :3, 0])
    m = torch.stack([pts[..., :3, 0], pts[..., :3, 1], ones], dim=-2)
    p4 = torch.stack([pts[..., 3, 0], pts[..., 3, 1], ones[..., 0]], dim=-1)
    return m * (_adjugate(m) @ p4[..., None])[..., 0][..., None, :]


def perspective_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homographies src[i] → dst[i], normalised to M[2, 2] = 1."""
    m = _basis(dst.float()) @ _adjugate(_basis(src.float()))
    return m / m[..., 2:3, 2:3]


def invert_homography(m: torch.Tensor) -> torch.Tensor:
    adj = _adjugate(m)
    det = m[..., 0, 0] * adj[..., 0, 0] + m[..., 0, 1] * adj[..., 1, 0] + m[..., 0, 2] * adj[..., 2, 0]
    return adj / det[..., None, None]


def _guard(den: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(den) < 1e-8, torch.full_like(den, 1e-8), den)


def _rows(minv: torch.Tensor, r: int) -> list[torch.Tensor]:
    return [minv[:, r, k][:, None, None] for k in range(3)]


def position_hx(minv: torch.Tensor, us: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Pass 1's source column X(u, v*) where Y(u, v*) = y."""
    (a_, b_, c_), (d_, e_, f_), (g_, h_, i_) = (_rows(minv, r) for r in range(3))
    v_star = (ys * (g_ * us + i_) - d_ * us - f_) / _guard(e_ - ys * h_)
    return (a_ * us + b_ * v_star + c_) / _guard(g_ * us + h_ * v_star + i_)


def position_vy(minv: torch.Tensor, us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Pass 2's source row Y(u, v)."""
    _, (d_, e_, f_), (g_, h_, i_) = (_rows(minv, r) for r in range(3))
    return (d_ * us + e_ * vs + f_) / _guard(g_ * us + h_ * vs + i_)


def twopass_positions(minv: torch.Tensor, src_h: int, out_h: int, out_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``hx`` (B, src_h, out_w) and ``vy`` (B, out_w, out_h)."""
    dev = minv.device
    ys = torch.arange(src_h, dtype=torch.float32, device=dev)[:, None].expand(src_h, out_w)
    us = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(src_h, out_w)
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :].expand(out_w, out_h)
    uu = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None].expand(out_w, out_h)
    return position_hx(minv, us, ys), position_vy(minv, uu, vs)


def hat_resample(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(..., J) rows sampled at (..., U) positions with weights
    max(0, 1 − |p − j|), zero outside: the full-width multiply-reduce."""
    j = src.shape[-1]
    src2 = src.reshape(-1, j).float()
    pos2 = pos.reshape(-1, pos.shape[-1]).float()
    jj = torch.arange(j, dtype=torch.float32, device=src.device)
    rows = max(1, (1 << 26) // (j * pos2.shape[-1]))
    out = torch.empty_like(pos2)
    for r0 in range(0, src2.shape[0], rows):
        p = pos2[r0 : r0 + rows]
        w = torch.clamp_min(1.0 - torch.abs(p[:, None, :] - jj[:, None]), 0.0)
        out[r0 : r0 + rows] = torch.sum(w * src2[r0 : r0 + rows, :, None], dim=-2)
    return out.reshape(*src.shape[:-1], pos.shape[-1])


def warp_twopass(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The two-pass warp in its plain order: rows at hx, then columns at vy."""
    hx, vy = twopass_positions(minv, imgs.shape[1], out_h, out_w)
    tmp = hat_resample(imgs, hx)
    return hat_resample(tmp.transpose(1, 2), vy).transpose(1, 2)


def warp_fused(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The same warp from each output's four taps: pass 2's two rows at vy,
    in each the two columns of pass 1 at hx.  At most two terms of each
    of ``warp_twopass``'s sums are nonzero, and these are they, so the two
    orders give the same floats; this one costs O(outputs)."""
    b, src_h, src_w = imgs.shape
    dev = imgs.device
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None].expand(out_h, out_w)
    us = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(out_h, out_w)
    flat = imgs.reshape(b, src_h * src_w).float()

    def taps(p: torch.Tensor, n: int):
        f = torch.floor(p)
        for j in (f, f + 1.0):
            wgt = torch.clamp_min(1.0 - torch.abs(p - j), 0.0)
            inside = (j >= 0) & (j < n)
            yield torch.where(inside, j, 0.0).long(), torch.where(inside, wgt, 0.0)

    out = torch.zeros((b, out_h, out_w), dtype=torch.float32, device=dev)
    for r, w2 in taps(position_vy(minv, us, vs), src_h):
        row = torch.zeros_like(out)
        for col, w1 in taps(position_hx(minv, us, r.float()), src_w):
            idx = (r * src_w + col).reshape(b, out_h * out_w)
            row = row + w1 * torch.gather(flat, 1, idx).reshape(b, out_h, out_w)
        out = out + w2 * row
    return out


# -- grid refinement ------------------------------------------------------------

_OFFSETS = np.arange(-32.0, 32.5, 0.5, dtype=np.float32)
_SPACINGS = np.arange(58.0, 70.25, 0.25, dtype=np.float32)
_CAND = np.array([(o, s) for o in _OFFSETS for s in _SPACINGS], dtype=np.float32)
_TRI = (np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32) / 9.0).tolist()
_COMB: np.ndarray | None = None


def _comb() -> np.ndarray:
    """(C, 512) comb of the interior lines k = 1..7 of every candidate."""
    global _COMB
    if _COMB is None:
        xs = np.arange(BOARD, dtype=np.float32)
        lines = _CAND[:, 0:1] + _CAND[:, 1:2] * np.arange(1, 8, dtype=np.float32)
        w = np.zeros((len(_CAND), BOARD), np.float32)
        for c in range(0, len(_CAND), 512):
            d = np.maximum(0.0, 1.0 - np.abs(xs[None, None, :] - lines[c : c + 512, :, None]))
            w[c : c + 512] = d.sum(axis=1)
        _COMB = w
    return _COMB


def _condition(p: torch.Tensor) -> torch.Tensor:
    sm = torch.zeros_like(p)
    for i, w in enumerate(_TRI):
        sh = i - 2
        if sh < 0:
            sm[:, :sh] = sm[:, :sh] + w * p[:, -sh:]
        elif sh > 0:
            sm[:, sh:] = sm[:, sh:] + w * p[:, :-sh]
        else:
            sm = sm + w * p
    s = torch.sort(sm, dim=-1).values
    n = sm.shape[-1]
    med = (s[..., n // 2 - 1 : n // 2] + s[..., n // 2 : n // 2 + 1]) * 0.5
    return torch.sqrt(torch.clamp_min(sm - med, 0.0))


def detect_grid(boards: torch.Tensor) -> torch.Tensor:
    """(B, 512, 512) rounded boards → (B, 4) ``(ox, sx, oy, sy)``."""
    b = boards.shape[0]
    x = boards.float()
    col = F.pad(torch.abs(x[:, :, 1:] - x[:, :, :-1]).sum(dim=1), (0, 1))
    row = F.pad(torch.abs(x[:, 1:, :] - x[:, :-1, :]).sum(dim=2), (0, 1))
    p = _condition(torch.cat([col, row], dim=0))
    comb_t = torch.from_numpy(_comb().T.copy()).to(p.device)
    osel = torch.from_numpy(_CAND).to(p.device)[torch.argmax(p @ comb_t, dim=-1)]
    return torch.cat([osel[:b], osel[b:]], dim=1)


def _axis_matrix(o: torch.Tensor, s: torch.Tensor, src: int, shift: float) -> torch.Tensor:
    u = torch.arange(BOARD, dtype=torch.float32, device=o.device)
    pos = (shift + o)[:, None] + u[None, :] * (s / CELL)[:, None]
    j = torch.arange(src, dtype=torch.float32, device=o.device)
    w = torch.clamp_min(1.0 - torch.abs(pos[:, :, None] - j[None, None, :]), 0.0)
    return w.to(torch.bfloat16).float()


def apply_correction(wide: torch.Tensor, corr: torch.Tensor, margin: int) -> torch.Tensor:
    """Resample (B, 512 + 2m, 512 + 2m) canvases so the detected grid lands
    on the ideal one; operands rounded to bf16, products summed in float32."""
    src = BOARD + 2 * margin
    rx = _axis_matrix(corr[:, 0], corr[:, 1], src, float(margin))
    ry = _axis_matrix(corr[:, 2], corr[:, 3], src, float(margin))
    t = torch.bmm(wide.to(torch.bfloat16).float(), rx.transpose(1, 2))
    return torch.bmm(ry, t.to(torch.bfloat16).float())


def refined_quadrangle(ms: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Frame corners (B, 4, 2) of the corrected board."""
    minv = invert_homography(ms)
    dev = corr.device
    cx = torch.tensor([0.0, BOARD, BOARD, 0.0], dtype=torch.float32, device=dev)
    cy = torch.tensor([0.0, 0.0, BOARD, BOARD], dtype=torch.float32, device=dev)
    ax = corr[:, 0:1] + cx[None, :] * (corr[:, 1:2] / CELL)
    ay = corr[:, 2:3] + cy[None, :] * (corr[:, 3:4] / CELL)
    img = torch.bmm(minv, torch.stack([ax, ay, torch.ones_like(ax)], dim=1))
    return (img[:, :2] / img[:, 2:3]).transpose(1, 2)


def squares(boards: torch.Tensor) -> torch.Tensor:
    """(B, 512, 512) → (B·64, 64, 64, 1), rank-major."""
    b, h, w = boards.shape
    sq = boards.reshape(b, 8, h // 8, 8, w // 8).permute(0, 1, 3, 2, 4)
    return sq.reshape(b * 64, h // 8, w // 8, 1)
