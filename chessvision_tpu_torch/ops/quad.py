"""Batched quadrangle extraction from board probability masks.

Counterpart of ``chessvision_tpu/ops/quad.py`` (which vmaps one mask at a
time); every step here carries the batch axis:

1. seed: the foreground pixel with the highest 9×9 box sum (zero padded);
2. dominant component at half resolution (2×2 OR-pool): rounds of
   row/column run-id reachability, then upsample and AND with the mask;
3. 64 hull support points from the per-row extremes;
4. deviation decimation down to 4 corners (60 sequential steps, a Python
   loop over batched tensors), then the reference's corner order;
5. the area, ratio, small-board, fit and convexity gates.

Corners are pixel coordinates and every gate is exact float arithmetic
on small integers, so the corners and ``found`` flags equal the JAX
package's on the same masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NUM_DIRECTIONS = 64
FLOOD_ROUNDS = 3

MIN_AREA_PERCENTAGE = 0.35
MAX_AREA_PERCENTAGE = 1.0
SMALL_BOARD_MIN_AREA = 0.05
MIN_RATIO_BOUNDING = 0.6


def _flood_pass_rows(mask: torch.Tensor, visited: torch.Tensor, run_id: torch.Tensor) -> torch.Tensor:
    """One reachability pass along the last axis: a mask pixel becomes
    visited if a visited mask pixel shares its run (same count of zeros to
    its left).  The JAX package tests run-id equality all against all
    (W² per row); here each run's flag is scattered once and gathered
    back, the same boolean result in W per row."""
    vj = (mask & visited).to(torch.int32)
    has = torch.zeros(
        (*run_id.shape[:-1], run_id.shape[-1] + 1), dtype=torch.int32, device=run_id.device
    )
    has.scatter_add_(-1, run_id, vj)
    reach = torch.gather(has, -1, run_id) > 0
    return visited | (mask & reach)


def connected_component(mask: torch.Tensor, seed_flat: torch.Tensor, rounds: int = FLOOD_ROUNDS) -> torch.Tensor:
    """Pixels of ``mask`` (B, H, W) bool connected to each board's seed
    (flat index, (B,)), by ``rounds`` row-then-column passes."""
    b, h, w = mask.shape
    visited = torch.zeros((b, h * w), dtype=torch.bool, device=mask.device)
    visited[torch.arange(b, device=mask.device), seed_flat] = True
    visited = visited.reshape(b, h, w) & mask
    mask_t = mask.transpose(1, 2)
    run_rows = torch.cumsum((~mask).to(torch.int64), dim=-1)
    run_cols = torch.cumsum((~mask_t).to(torch.int64), dim=-1)
    for _ in range(rounds):
        visited = _flood_pass_rows(mask, visited, run_rows)
        visited = _flood_pass_rows(mask_t, visited.transpose(1, 2), run_cols).transpose(1, 2)
    return visited


def _directions(k: int, device: torch.device) -> torch.Tensor:
    thetas = torch.arange(k, dtype=torch.float32, device=device) * (2.0 * math.pi / k)
    return torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=0)  # (2, k)


def support_points(component: torch.Tensor, k: int = NUM_DIRECTIONS) -> torch.Tensor:
    """(B, k, 2) hull support points (x, y) of (B, H, W) components, in
    direction-angle order.  The support in any direction is attained at a
    per-row extreme pixel, so the candidates are the 2·H row extremes."""
    b, h, w = component.shape
    dev = component.device
    xs = torch.arange(w, dtype=torch.int32, device=dev).expand(b, h, w)
    big = 1 << 20
    min_x = torch.where(component, xs, big).amin(dim=2)
    max_x = torch.where(component, xs, -big).amax(dim=2)
    row_valid = component.any(dim=2)
    ys = torch.arange(h, dtype=torch.float32, device=dev).expand(b, h)
    cand = torch.cat(
        [torch.stack([min_x.float(), ys], dim=2), torch.stack([max_x.float(), ys], dim=2)], dim=1
    )  # (B, 2h, 2)
    valid = torch.cat([row_valid, row_valid], dim=1)
    dirs = _directions(k, dev)
    proj = cand @ dirs  # (B, 2h, k)
    proj = torch.where(valid[:, :, None], proj, -3.0e8)
    idx = torch.argmax(proj, dim=1)  # (B, k), first index on ties
    return torch.gather(cand, 1, idx[:, :, None].expand(b, k, 2))


def decimate_to_quad(points: torch.Tensor) -> torch.Tensor:
    """Decimate closed polygons (B, k, 2), in order, to 4 vertices by
    repeatedly removing the active vertex with the smallest deviation from
    the chord of its active neighbours (lower index first on ties).
    Returns (B, 4, 2) in traversal order."""
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
        dist = cross / torch.clamp_min(chord, 1e-6)
        devs = torch.where(active, dist + tie, 3.0e18)
        r = torch.argmin(devs, dim=1)
        pr = prv[rows, r]
        nx = nxt[rows, r]
        active[rows, r] = False
        nxt[rows, pr] = nx
        prv[rows, nx] = pr
    i0 = torch.argmax(active.to(torch.int32), dim=1)
    i1 = nxt[rows, i0]
    i2 = nxt[rows, i1]
    i3 = nxt[rows, i2]
    sel = torch.stack([i0, i1, i2, i3], dim=1)
    return torch.gather(points, 1, sel[:, :, None].expand(b, 4, 2))


def order_like_reference(quad: torch.Tensor) -> torch.Tensor:
    """(B, 4, 2) corners in OpenCV contour order (reverse traversal, start
    at the topmost then leftmost corner), then the reference's rotate rule:
    if pt0.x < pt2.x, take [3, 0, 1, 2]."""
    b = quad.shape[0]
    q = torch.flip(quad, dims=(1,))
    score = q[..., 1] * 4096.0 + q[..., 0]
    start = torch.argmin(score, dim=1)
    idx = (torch.arange(4, device=quad.device)[None, :] + start[:, None]) % 4
    q = torch.gather(q, 1, idx[:, :, None].expand(b, 4, 2))
    rotated = q[:, [3, 0, 1, 2]]
    return torch.where((q[:, 0, 0] < q[:, 2, 0])[:, None, None], rotated, q)


def _shoelace(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.abs(
        torch.sum(x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y, dim=-1)
    )


def find_quadrangle_batch(
    probabilities: torch.Tensor,
    threshold: float = 0.5,
    k: int = NUM_DIRECTIONS,
    rounds: int = FLOOD_ROUNDS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) probability masks → (quads (B, 4, 2) float32 in mask
    pixels, found (B,) bool)."""
    probs = probabilities.float()
    b, h, w = probs.shape
    dev = probs.device
    mask = probs > threshold

    # seed: highest 9×9 box sum (SAME, zero padded) among foreground pixels
    box = torch.ones((1, 1, 9, 9), dtype=torch.float32, device=dev)
    smoothed = F.conv2d(probs[:, None], box, padding=4)[:, 0]
    seed = torch.argmax(torch.where(mask, smoothed, -1.0).reshape(b, -1), dim=1)

    mask_small = mask.reshape(b, h // 2, 2, w // 2, 2).any(dim=4).any(dim=2)
    seed_y, seed_x = seed // w, seed % w
    seed_small = (seed_y // 2) * (w // 2) + seed_x // 2
    comp_small = connected_component(mask_small, seed_small, rounds)
    comp = comp_small.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) & mask
    area = comp.sum(dim=(1, 2), dtype=torch.float32)
    foreground = mask.sum(dim=(1, 2), dtype=torch.float32)
    mask_area = float(h * w)

    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(b, h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(b, h, w)
    big = 1 << 30
    min_x = torch.where(comp, xs, big).amin(dim=(1, 2))
    max_x = torch.where(comp, xs, -big).amax(dim=(1, 2))
    min_y = torch.where(comp, ys, big).amin(dim=(1, 2))
    max_y = torch.where(comp, ys, -big).amax(dim=(1, 2))
    bb_w = (max_x - min_x + 1).float()
    bb_h = (max_y - min_y + 1).float()
    ratio = torch.minimum(bb_w, bb_h) / torch.clamp_min(torch.maximum(bb_w, bb_h), 1.0)

    pts = support_points(comp, k)
    quad = order_like_reference(decimate_to_quad(pts))
    quad_area = _shoelace(quad[..., 0], quad[..., 1])
    hull_area = _shoelace(pts[..., 0], pts[..., 1])

    # filters only apply when the seeded component is not the whole
    # foreground; a dominant component may be a small board (≥ 5% of the
    # frame) if it is square enough and convex (pixel area ≈ hull area)
    multiple = area < foreground
    filters_pass = (
        (area / mask_area >= MIN_AREA_PERCENTAGE)
        & (area / mask_area <= MAX_AREA_PERCENTAGE)
        & (ratio >= MIN_RATIO_BOUNDING)
    )
    dominant = area >= 0.95 * foreground
    small_board_ok = (
        dominant
        & (area / mask_area >= SMALL_BOARD_MIN_AREA)
        & (ratio >= MIN_RATIO_BOUNDING)
        & (area >= 0.85 * hull_area)
    )
    found = (
        torch.where(multiple, filters_pass | small_board_ok, True)
        & (quad_area <= 1.45 * area)
        & (area > 0)
    )
    return quad.float(), found


def find_quadrangle(
    probabilities: torch.Tensor, threshold: float = 0.5, k: int = NUM_DIRECTIONS, rounds: int = FLOOD_ROUNDS
) -> tuple[torch.Tensor, torch.Tensor]:
    """The board quadrangle of one (H, W) probability mask: ((4, 2) float32
    in mask pixels, 0-d found flag).  The JAX package's batch is a vmap of
    its single-mask function; here the single mask is a batch of one."""
    quad, found = find_quadrangle_batch(probabilities[None], threshold, k, rounds)
    return quad[0], found[0]


def scale_quadrangle(quad: torch.Tensor, orig_h: float, mask_h: int = 256) -> torch.Tensor:
    """Mask-space quad → original-image coords.  Both axes scale by
    orig_h / mask_h — the reference's quirk of using the height for x,
    kept for output parity."""
    sf = torch.tensor(orig_h, dtype=torch.float32) / torch.tensor(float(mask_h), dtype=torch.float32)
    return quad * sf.to(quad.device)
