"""Inputs of the quadrangle tests, made without JAX, so that the CPU parity
tests and the card tests share them.

- ``masks()``: probability masks (256²) of boards, specks and shapes that
  each exercise a branch of the quadrangle's gates;
- ``polygons(kind, k, b)``: seeded closed polygons (b, k, 2) of integer
  coordinates in [0, 255]² whose decimation is full of ties;
- ``mask_support_points()``: the support points that the port's quadrangle
  hands its decimation for some of those masks, on the CPU.
"""

from __future__ import annotations

import numpy as np

# the masks whose support points feed the decimation tests
DECIMATION_MASKS = ("stub_quad", "rotated", "tilted", "specks", "small_board")
POLYGON_KINDS = ("scattered", "star", "repeated", "collinear", "equal")


def fill_convex(pts: np.ndarray, size: int = 256) -> np.ndarray:
    """bool (size, size) mask of pixels inside a convex polygon (x, y)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    inside = np.ones((size, size), bool)
    sign = None
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % len(pts)]
        cross = (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)
        if sign is None:
            sign = 1.0 if np.sum(cross >= 0) > np.sum(cross <= 0) else -1.0
        inside &= sign * cross >= 0
    return inside


def quad_probs(pts: list[list[float]]) -> np.ndarray:
    """Probability map of a hard mask: sigmoid(±8) inside/outside."""
    m = fill_convex(np.asarray(pts, np.float64))
    return np.where(m, 1 / (1 + np.exp(-8.0)), 1 / (1 + np.exp(8.0))).astype(np.float32)


def masks() -> dict[str, np.ndarray]:
    stub = [[32, 28], [224, 30], [226, 228], [30, 226]]  # tests/test_engine.py stub quad
    out = {
        "stub_quad": quad_probs(stub),
        "rotated": quad_probs([[128, 30], [226, 128], [128, 226], [30, 128]]),
        "tilted": quad_probs([[40, 40], [215, 50], [220, 220], [35, 210]]),
        "empty": np.zeros((256, 256), np.float32),
    }
    speck = quad_probs([[40, 40], [215, 50], [220, 220], [35, 210]])
    rng = np.random.default_rng(1)
    for _ in range(20):
        y, x = rng.integers(0, 30, 2)
        speck[y : y + 3, x : x + 3] = 0.99
    speck[128, 128] = 1.0
    out["specks"] = speck
    small = np.zeros((256, 256), np.float32)
    small[90:210, 80:200] = 1.0  # 22% of frame plus a speck: small-board fallback
    small[10:14, 10:14] = 1.0
    out["small_board"] = small
    tiny = np.zeros((256, 256), np.float32)
    tiny[120:150, 120:150] = 1.0  # under the 5% floor plus a speck: rejected
    tiny[10:14, 10:14] = 1.0
    out["tiny_board"] = tiny
    u = np.zeros((256, 256), np.float32)
    u[40:220, 40:90] = 1.0
    u[40:220, 170:220] = 1.0
    u[180:220, 40:220] = 1.0
    u[10:40, 230:250] = 1.0
    out["u_shape_speck"] = u
    return out


def polygons(kind: str, k: int, b: int, seed: int = 0) -> np.ndarray:
    """(b, k, 2) float32 polygons of integers in [0, 255]², the first n of
    b the same for any b ≥ n:

    - ``scattered``: every point drawn on its own (self-crossing polygons);
    - ``star``: points around a centre in angle order, like support points;
    - ``repeated``: a few points, each held for a run of places (zero chords);
    - ``collinear``: the integer border of a rectangle, walked in order, so
      most deviations are 0 and the tie term alone orders them;
    - ``equal``: one point k times.
    """
    rng = np.random.default_rng([seed, POLYGON_KINDS.index(kind), k])
    out = np.empty((b, k, 2), np.float32)
    for n in range(b):
        if kind == "scattered":
            p = rng.integers(0, 256, (k, 2))
        elif kind == "star":
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(20, 127, k)
            p = np.rint(np.stack([127.5 + r * np.cos(ang), 127.5 + r * np.sin(ang)], 1))
        elif kind == "repeated":
            m = int(rng.integers(1, min(k, 6) + 1))
            p = rng.integers(0, 256, (m, 2))[np.sort(rng.integers(0, m, k))]
        elif kind == "collinear":
            x0, y0 = rng.integers(0, 128, 2)
            w, h = rng.integers(4, 128, 2)
            border = [(x, y0) for x in range(x0, x0 + w)] + [(x0 + w, y) for y in range(y0, y0 + h)]
            border += [(x, y0 + h) for x in range(x0 + w, x0, -1)] + [(x0, y) for y in range(y0 + h, y0, -1)]
            border = np.asarray(border)
            p = border[np.sort(rng.choice(len(border), k, replace=len(border) < k))]
        elif kind == "equal":
            p = np.repeat(rng.integers(0, 256, (1, 2)), k, axis=0)
        else:
            raise ValueError(kind)
        out[n] = p
    return out


def mask_support_points(names: tuple[str, ...] = DECIMATION_MASKS) -> np.ndarray:
    """(len(names), 64, 2) float32: the support points that the port's
    ``find_quadrangle_batch`` hands its decimation for ``masks()[name]``, on
    the CPU."""
    import torch

    from chessvision_tpu_torch.ops import quad

    seen = []
    real = quad.decimate_to_quad

    def record(points):
        seen.append(points.clone())
        return real(points)

    quad.decimate_to_quad = record
    try:
        quad.find_quadrangle_batch(torch.from_numpy(np.stack([masks()[n] for n in names])), 0.5)
    finally:
        quad.decimate_to_quad = real
    return seen[0].numpy()
