"""Synthetic board photos in numpy, made from a seed, and datasets of them.

A themed 8×8 checkerboard with disc-shaped pieces (white discs read as
``P``, black ones as ``p``), inside a dark frame, warped by a known
homography into a cluttered background.  The square frames
(``board_frames``) need no cv2, so the port can be driven end to end
anywhere; ``photo_frames`` composes the board with cv2 into a canvas of
any camera's size, landscape or portrait.  Both are uint8 BGR like a
camera's.

The dataset writers (these use cv2 to encode) lay seeded data out as the
trainers and the evaluation read it, so neither needs ``data/``:
``write_segmentation_dataset`` (``board_extraction/images`` + ``masks``,
each mask the filled board quad), ``write_squares_dataset``
(``squares/{training,validation}/<class>/``, 64² gray crops of the 13
classes) and ``write_test_root`` (``<batch>/raw/*.JPG`` with
``ground_truth/*.txt`` FENs).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# class directories of the squares dataset: sorted, they give the label
# order of constants.LABEL_NAMES
SQUARE_CLASS_DIRS = ["B", "K", "N", "P", "Q", "R", "_b", "_k", "_n", "_p", "_q", "_r", "f"]

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


def _board_texture(rng: np.random.Generator, side: int) -> tuple[np.ndarray, str]:
    """(side, side, 3) board: a frame of side/16 px around 8×8 squares; and
    its FEN (white discs ``P``, black discs ``p``)."""
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
    return tex, _fen(occupied, white)


def _fen(occupied: np.ndarray, white: np.ndarray) -> str:
    rows = []
    for r in range(8):
        row, empty = "", 0
        for c in range(8):
            if occupied[r, c]:
                row += (str(empty) if empty else "") + ("P" if white[r, c] else "p")
                empty = 0
            else:
                empty += 1
        rows.append(row + (str(empty) if empty else ""))
    return "/".join(rows)


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
    img, quad, _ = board_frame_with_fen(rng, size)
    return img, quad


def board_frame_with_fen(rng: np.random.Generator, size: int = 512) -> tuple[np.ndarray, np.ndarray, str]:
    """``board_frame`` and the FEN of the board's discs."""
    side = 256
    tex, fen = _board_texture(rng, side)
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
    return np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8), quad.astype(np.float32), fen


def board_frames(seed: int, n: int, size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """``n`` frames (n, size, size, 3) uint8 and their quads (n, 4, 2)."""
    rng = np.random.default_rng(seed)
    pairs = [board_frame(rng, size) for _ in range(n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def photo_frame(rng: np.random.Generator, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """One (h, w, 3) uint8 BGR frame at a camera's size, landscape or
    portrait, and its board quad (4, 2) in frame pixels: a 512² board
    texture warped (cv2, bilinear) into a canvas with a colour gradient
    down its rows, flat clutter rectangles and ±3 levels of noise.  Built
    in uint8 throughout, so a 48 MP frame costs its 146 MB and little
    more."""
    import cv2

    side = 512
    tex, _ = _board_texture(rng, side)
    scale = rng.uniform(0.55, 0.85) * min(h, w)
    half = scale / 2
    cx = rng.uniform(half + 4, w - half - 4)
    cy = rng.uniform(half + 4, h - half - 4)
    corners = np.array([[-half, -half], [half, -half], [half, half], [-half, half]])
    ang = rng.uniform(-0.12, 0.12)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    quad = corners @ rot.T + rng.uniform(-0.03, 0.03, (4, 2)) * scale + [cx, cy]
    quad = np.clip(quad, 1, [w - 2, h - 2])

    base = rng.uniform(60, 220, 3)
    grad = np.linspace(0, rng.uniform(-50, 50), h)
    column = np.clip(np.floor(base[None] + grad[:, None] + 0.5), 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(np.broadcast_to(column[:, None], (h, w, 3)))
    for _ in range(rng.integers(4, 12)):  # clutter: flat rectangles
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        rh, rw = rng.integers(4, h // 4), rng.integers(4, w // 4)
        img[y : y + rh, x : x + rw] = rng.uniform(0, 255, 3).astype(np.uint8)
    src = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float64)
    cv2.warpPerspective(tex.astype(np.uint8), _homography(src, quad), (w, h), dst=img,
                        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_TRANSPARENT)
    noise = rng.integers(0, 7, (h, w, 3), dtype=np.uint8)
    cv2.add(img, noise, dst=img)
    cv2.subtract(img, (3.0, 3.0, 3.0, 0.0), dst=img)
    return img, quad.astype(np.float32)


def photo_frames(seed: int, n: int, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` camera-size frames (n, h, w, 3) uint8 and their quads (n, 4, 2)."""
    rng = np.random.default_rng(seed)
    frames = np.empty((n, h, w, 3), np.uint8)
    quads = np.empty((n, 4, 2), np.float32)
    for i in range(n):
        frames[i], quads[i] = photo_frame(rng, h, w)
    return frames, quads


def limit_chroma(frames: np.ndarray) -> np.ndarray:
    """``frames`` with every pixel's color pulled halfway to its gray, so that
    B − Y and R − Y stay inside int8 as they do in board photos (the flat
    clutter rectangles above take any color, and their chroma clips in the
    yuv444 codec)."""
    f = frames.astype(np.float32)
    gray = (f @ np.array([0.114, 0.587, 0.299], np.float32))[..., None]
    return np.clip(np.floor(gray + 0.5 * (f - gray) + 0.5), 0, 255).astype(np.uint8)


def quad_mask(quad: np.ndarray, size: int) -> np.ndarray:
    """(size, size) uint8 mask, 255 inside the convex quad (pixel centers
    on or inside its clockwise-on-screen edges)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    inside = np.ones((size, size), bool)
    for i in range(4):
        (x0, y0), (x1, y1) = quad[i], quad[(i + 1) % 4]
        inside &= (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0) >= 0
    return np.where(inside, 255, 0).astype(np.uint8)


def write_segmentation_dataset(root: str | Path, n: int, seed: int, size: int = 256) -> Path:
    """``n`` board frames and their masks as ``root/board_extraction/
    {images,masks}/NNNN.png``; returns ``root``."""
    import cv2

    base = Path(root) / "board_extraction"
    (base / "images").mkdir(parents=True, exist_ok=True)
    (base / "masks").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, quad, _ = board_frame_with_fen(rng, size)
        cv2.imwrite(str(base / "images" / f"{i:04d}.png"), img)
        cv2.imwrite(str(base / "masks" / f"{i:04d}.png"), quad_mask(quad, size))
    return Path(root)


def square_crop(rng: np.random.Generator, class_dir: str) -> np.ndarray:
    """One 64² uint8 gray square of a class: a light or dark ground with the
    piece's letter (white pieces light, black pieces dark), jittered."""
    import cv2

    img = np.full((64, 64), int(rng.uniform(90, 220)), np.uint8)
    if class_dir != "f":
        letter = class_dir[-1].upper()
        color = int(rng.uniform(225, 255)) if not class_dir.startswith("_") else int(rng.uniform(0, 40))
        scale = rng.uniform(1.2, 1.6)
        (tw, th), _ = cv2.getTextSize(letter, cv2.FONT_HERSHEY_SIMPLEX, scale, 3)
        org = (int((64 - tw) / 2 + rng.integers(-4, 5)), int((64 + th) / 2 + rng.integers(-4, 5)))
        cv2.putText(img, letter, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, 3, cv2.LINE_AA)
    noisy = img.astype(np.float32) + rng.normal(0.0, 4.0, img.shape)
    return np.clip(np.floor(noisy + 0.5), 0, 255).astype(np.uint8)


def write_squares_dataset(root: str | Path, n_train: int, n_val: int, seed: int) -> Path:
    """``n_train`` and ``n_val`` squares per class as ``root/squares/
    {training,validation}/<class>/NNNN.png``; returns ``root``."""
    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("training", n_train), ("validation", n_val)):
        for c in SQUARE_CLASS_DIRS:
            d = Path(root) / "squares" / split / c
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                cv2.imwrite(str(d / f"{i:04d}.png"), square_crop(rng, c))
    return Path(root)


def write_test_root(root: str | Path, n: int, seed: int, sizes: tuple[int, ...] = (512,)) -> Path:
    """``n`` frames (sizes taken in turn) as ``root/batch0/raw/imgNN.JPG``
    with their FENs in ``root/batch0/ground_truth/imgNN.txt``; returns
    ``root``, the layout ``eval.evaluate.get_test_generator`` reads."""
    import cv2

    raw, truth = Path(root) / "batch0" / "raw", Path(root) / "batch0" / "ground_truth"
    raw.mkdir(parents=True, exist_ok=True)
    truth.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, _, fen = board_frame_with_fen(rng, sizes[i % len(sizes)])
        cv2.imwrite(str(raw / f"img{i:02d}.JPG"), img)
        (truth / f"img{i:02d}.txt").write_text(fen)
    return Path(root)
