"""Synthetic board photos in numpy, made from a seed.

A themed 8×8 checkerboard with disc-shaped pieces, inside a dark frame,
warped by a known homography into a cluttered background.  Needs no cv2,
so the port can be driven end to end anywhere; the frames are uint8 BGR
like a camera's.
"""

from __future__ import annotations

import numpy as np

# (light, dark) square colors, BGR
_THEMES = [
    ((181, 217, 240), (99, 136, 181)),
    ((210, 238, 238), (86, 150, 118)),
    ((230, 227, 222), (173, 162, 140)),
    ((220, 220, 220), (150, 150, 150)),
]


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 homography mapping 4 src points onto 4 dst points (float64)."""
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    h = np.linalg.solve(np.asarray(a, np.float64), dst.reshape(-1).astype(np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _board_texture(rng: np.random.Generator, side: int) -> np.ndarray:
    """(side, side, 3) board: a frame of side/16 px around 8×8 squares."""
    light, dark = _THEMES[rng.integers(len(_THEMES))]
    frame = side // 16
    cell = (side - 2 * frame) / 8
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    fy, fx = (yy - frame) / cell, (xx - frame) / cell
    inside = (fy >= 0) & (fy < 8) & (fx >= 0) & (fx < 8)
    parity = (np.floor(fy) + np.floor(fx)) % 2
    tex = np.where(parity[..., None] == 0, np.asarray(light), np.asarray(dark)).astype(np.float32)
    occupied = rng.random((8, 8)) < 0.35
    white = rng.random((8, 8)) < 0.5
    ry, rx = fy - np.floor(fy) - 0.5, fx - np.floor(fx) - 0.5
    disc = (ry**2 + rx**2) < 0.33**2
    iy = np.clip(np.floor(fy), 0, 7).astype(int)
    ix = np.clip(np.floor(fx), 0, 7).astype(int)
    piece = disc & inside & occupied[iy, ix]
    piece_color = np.where(white[iy, ix][..., None], 235.0, 30.0)
    tex = np.where(piece[..., None], piece_color, tex)
    tex = np.where(inside[..., None], tex, np.float32(40.0))
    return tex


def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    base = rng.uniform(60, 220, 3).astype(np.float32)
    grad = np.linspace(0, rng.uniform(-50, 50), size, dtype=np.float32)
    bg = np.broadcast_to(base[None, None] + grad[:, None, None], (size, size, 3)).copy()
    for _ in range(rng.integers(4, 12)):  # clutter: flat rectangles
        y, x = rng.integers(0, size - 8, 2)
        h, w = rng.integers(4, size // 4, 2)
        bg[y : y + h, x : x + w] = rng.uniform(0, 255, 3)
    return bg


def board_frame(rng: np.random.Generator, size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """One (size, size, 3) uint8 BGR frame and its board quad (4, 2) in
    frame pixels, corners clockwise from the top-left."""
    side = 256
    tex = _board_texture(rng, side)
    scale = rng.uniform(0.55, 0.85) * size
    cx, cy = rng.uniform(scale / 2 + 4, size - scale / 2 - 4, 2)
    half = scale / 2
    corners = np.array([[-half, -half], [half, -half], [half, half], [-half, half]])
    ang = rng.uniform(-0.12, 0.12)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    quad = corners @ rot.T + rng.uniform(-0.03, 0.03, (4, 2)) * scale + [cx, cy]
    quad = np.clip(quad, 1, size - 2)
    src = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float64)
    hinv = np.linalg.inv(_homography(src, quad))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    pts = hinv @ np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5, np.ones(size * size)])
    tx = (pts[0] / pts[2]).reshape(size, size) - 0.5
    ty = (pts[1] / pts[2]).reshape(size, size) - 0.5
    inside = (tx >= 0) & (tx <= side - 1) & (ty >= 0) & (ty <= side - 1)
    x0 = np.clip(np.floor(tx), 0, side - 2).astype(int)
    y0 = np.clip(np.floor(ty), 0, side - 2).astype(int)
    fx = np.clip(tx - x0, 0, 1)[..., None]
    fy = np.clip(ty - y0, 0, 1)[..., None]
    sample = (
        tex[y0, x0] * (1 - fx) * (1 - fy)
        + tex[y0, x0 + 1] * fx * (1 - fy)
        + tex[y0 + 1, x0] * (1 - fx) * fy
        + tex[y0 + 1, x0 + 1] * fx * fy
    )
    img = np.where(inside[..., None], sample, _background(rng, size))
    img += rng.normal(0.0, 3.0, img.shape)
    return np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8), quad.astype(np.float32)


def board_frames(seed: int, n: int, size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """``n`` frames (n, size, size, 3) uint8 and their quads (n, 4, 2)."""
    rng = np.random.default_rng(seed)
    pairs = [board_frame(rng, size) for _ in range(n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def limit_chroma(frames: np.ndarray) -> np.ndarray:
    """``frames`` with every pixel's color pulled halfway to its gray, so that
    B − Y and R − Y stay inside int8 as they do in board photos (the flat
    clutter rectangles above take any color, and their chroma clips in the
    yuv444 codec)."""
    f = frames.astype(np.float32)
    gray = (f @ np.array([0.114, 0.587, 0.299], np.float32))[..., None]
    return np.clip(np.floor(gray + 0.5 * (f - gray) + 0.5), 0, 255).astype(np.uint8)
