"""Seeded camera frames, made in bulk on the device.

The scene is the repo's synthetic board photo: a themed 8×8 board with
disc-shaped pieces inside a dark frame, warped by a random homography
(scale 0.55–0.85 of the short side, ±0.12 rad, ±3% corner jitter) onto a
background with a colour gradient down its rows and 4–11 flat clutter
rectangles, plus noise; uint8 BGR.  The parameters of each frame come from
``numpy.random.default_rng(seed)``; the pixels, and the noise from a
``torch.Generator`` seeded alike, are computed on the device.  The same
seed gives the same frames on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

# (light, dark) square colours, BGR
THEMES = [
    ((181, 217, 240), (99, 136, 181)),
    ((210, 238, 238), (86, 150, 118)),
    ((230, 227, 222), (173, 162, 140)),
    ((220, 220, 220), (150, 150, 150)),
]


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    a, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(rhs, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _params(rng: np.random.Generator, h: int, w: int, side: int) -> dict:
    light, dark = THEMES[rng.integers(len(THEMES))]
    occupied = rng.random((8, 8)) < 0.35
    white = rng.random((8, 8)) < 0.5
    scale = rng.uniform(0.55, 0.85) * min(h, w)
    half = scale / 2
    cx = rng.uniform(half + 4, w - half - 4)
    cy = rng.uniform(half + 4, h - half - 4)
    ang = rng.uniform(-0.12, 0.12)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    corners = np.array([[-half, -half], [half, -half], [half, half], [-half, half]])
    quad = corners @ rot.T + rng.uniform(-0.03, 0.03, (4, 2)) * scale + [cx, cy]
    quad = np.clip(quad, 1, [w - 2, h - 2])
    src = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float64)
    base = rng.uniform(60, 220, 3)
    grad = rng.uniform(-50, 50)
    rects = []
    for _ in range(rng.integers(4, 12)):
        y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        rh, rw = int(rng.integers(4, h // 4)), int(rng.integers(4, w // 4))
        rects.append((y, x, rh, rw, rng.uniform(0, 255, 3)))
    return {
        "light": light, "dark": dark, "occupied": occupied, "white": white,
        "hinv": np.linalg.inv(_homography(src, quad)), "base": base, "grad": grad, "rects": rects,
    }


def _texture(p: dict, side: int, dev: torch.device) -> torch.Tensor:
    """(side, side, 3) float32 board texture with a side/16 frame."""
    frame = side // 16
    cell = (side - 2 * frame) / 8
    yy, xx = torch.meshgrid(torch.arange(side, device=dev, dtype=torch.float32),
                            torch.arange(side, device=dev, dtype=torch.float32), indexing="ij")
    fy, fx = (yy - frame) / cell, (xx - frame) / cell
    inside = (fy >= 0) & (fy < 8) & (fx >= 0) & (fx < 8)
    parity = (torch.floor(fy) + torch.floor(fx)) % 2
    light = torch.tensor(p["light"], dtype=torch.float32, device=dev)
    dark = torch.tensor(p["dark"], dtype=torch.float32, device=dev)
    tex = torch.where(parity[..., None] == 0, light, dark)
    iy = torch.clamp(torch.floor(fy), 0, 7).long()
    ix = torch.clamp(torch.floor(fx), 0, 7).long()
    occ = torch.from_numpy(p["occupied"]).to(dev)[iy, ix]
    wht = torch.from_numpy(p["white"]).to(dev)[iy, ix]
    ry, rx = fy - torch.floor(fy) - 0.5, fx - torch.floor(fx) - 0.5
    piece = ((ry * ry + rx * rx) < 0.33**2) & inside & occ
    tex = torch.where(piece[..., None], torch.where(wht, 235.0, 30.0)[..., None], tex)
    return torch.where(inside[..., None], tex, torch.tensor(40.0, device=dev))


def _render(p: dict, h: int, w: int, side: int, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    """One (h, w, 3) uint8 frame."""
    img = torch.tensor(p["base"], dtype=torch.float32, device=dev)[None, None, :] + torch.linspace(
        0.0, float(p["grad"]), h, device=dev)[:, None, None]
    img = img.expand(h, w, 3).contiguous()
    for y, x, rh, rw, colour in p["rects"]:
        img[y : y + rh, x : x + rw] = torch.tensor(colour, dtype=torch.float32, device=dev)
    tex = _texture(p, side, dev)
    hinv = torch.tensor(p["hinv"], dtype=torch.float64, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float64)[:, None] + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float64)[None, :] + 0.5
    den = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    tx = ((hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / den - 0.5).float()
    ty = ((hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / den - 0.5).float()
    del den
    inside = (tx >= 0) & (tx <= side - 1) & (ty >= 0) & (ty <= side - 1)
    x0 = torch.clamp(torch.floor(tx), 0, side - 2)
    y0 = torch.clamp(torch.floor(ty), 0, side - 2)
    fx = torch.clamp(tx - x0, 0, 1)[..., None]
    fy = torch.clamp(ty - y0, 0, 1)[..., None]
    flat = tex.reshape(side * side, 3)
    i00 = (y0 * side + x0).long()

    def at(off: int) -> torch.Tensor:
        return flat[i00 + off]

    sample = (at(0) * (1 - fx) * (1 - fy) + at(1) * fx * (1 - fy)
              + at(side) * (1 - fx) * fy + at(side + 1) * fx * fy)
    img = torch.where(inside[..., None], sample, img)
    del sample, tx, ty, fx, fy, i00
    img += torch.randn((h, w, 3), generator=g, device=dev) * 3.0
    return torch.clamp(torch.floor(img + 0.5), 0, 255).to(torch.uint8)


def scenes(seed: int, sizes: list[tuple[int, int]], side: int, device: torch.device) -> list[torch.Tensor]:
    """One uint8 (h, w, 3) frame on ``device`` for each (h, w) of ``sizes``,
    from ``seed``; the board texture is ``side`` pixels square."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return [_render(_params(rng, h, w, side), h, w, side, g, device) for h, w in sizes]
