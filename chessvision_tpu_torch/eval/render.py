"""Board rendering for evaluation artifacts, the counterpart of
``chessvision_tpu/eval/render.py``.

``render_board_png`` draws a FEN as colored squares with piece letters in
numpy and writes it with cv2 (the GPU machine has cv2 and no matplotlib;
the JAX package draws unicode glyphs with matplotlib).  ``display_comparison``,
the notebook helper, composes its panels with numpy and cv2 as well and
returns the composed image; only ``show=True`` imports matplotlib.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from chessvision_tpu_torch.chessboard import expand_fen

LIGHT = (181, 217, 240)  # BGR of #f0d9b5
DARK = (99, 136, 181)  # BGR of #b58863


def render_board(fen: str, size: int = 400) -> np.ndarray:
    """A board FEN drawn as a (size, size, 3) uint8 BGR image (``size``
    rounded down to a multiple of 8): white pieces as dark-outlined white
    letters, black pieces as black letters."""
    import cv2

    expanded = expand_fen(fen)
    cell = size // 8
    img = np.zeros((cell * 8, cell * 8, 3), np.uint8)
    for rank in range(8):  # rank 0 = top (8th rank)
        for file in range(8):
            y, x = rank * cell, file * cell
            img[y : y + cell, x : x + cell] = LIGHT if (rank + file) % 2 == 0 else DARK
            piece = expanded[rank * 8 + file]
            if piece == ".":
                continue
            scale = cell / 40.0
            letter = piece.upper()
            (tw, th), _ = cv2.getTextSize(letter, cv2.FONT_HERSHEY_SIMPLEX, scale, 2)
            org = (x + (cell - tw) // 2, y + (cell + th) // 2)
            if piece.isupper():
                cv2.putText(img, letter, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 5, cv2.LINE_AA)
                cv2.putText(img, letter, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 2, cv2.LINE_AA)
            else:
                cv2.putText(img, letter, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 3, cv2.LINE_AA)
    return img


def render_board_png(fen: str, path: str | Path, size: int = 400) -> Path:
    """Render a board FEN to a PNG file (``render_board``)."""
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), render_board(fen, size))
    return path


def save_eval_artifacts(
    out_dir: str | Path,
    name: str,
    *,
    fen: str | None = None,
    binary_mask: np.ndarray | None = None,
    board_image: np.ndarray | None = None,
) -> dict[str, Path]:
    """Persist the per-image eval artifacts: predicted-board render, binary
    mask, extracted board.  Returns ``{kind: path}`` for the per-sample
    table's path columns."""
    import cv2

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: dict[str, Path] = {}
    stem = Path(name).stem
    if fen:
        written["predicted_board"] = render_board_png(fen, out / f"{stem}_predicted.png")
    if binary_mask is not None:
        p = out / f"{stem}_mask.png"
        cv2.imwrite(str(p), binary_mask)
        written["binary_mask"] = p
    if board_image is not None:
        p = out / f"{stem}_board.png"
        cv2.imwrite(str(p), board_image)
        written["extracted_board"] = p
    return written


PANEL = 256  # side of each panel of ``display_comparison``, in pixels
TITLE = 24  # height of the title strip above a panel
GAP = 8  # white space between panels


def _panel(img: np.ndarray, title: str) -> np.ndarray:
    """``img`` (gray or BGR uint8) fitted into a white PANEL² square,
    centered, under a title strip: (TITLE + PANEL, PANEL, 3) uint8."""
    import cv2

    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    h, w = img.shape[:2]
    scale = PANEL / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    interp = cv2.INTER_AREA if scale < 1 else cv2.INTER_NEAREST
    out = np.full((TITLE + PANEL, PANEL, 3), 255, np.uint8)
    y, x = TITLE + (PANEL - nh) // 2, (PANEL - nw) // 2
    out[y : y + nh, x : x + nw] = cv2.resize(np.ascontiguousarray(img), (nw, nh), interpolation=interp)
    cv2.putText(out, title, (4, TITLE - 7), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 0, 0), 1, cv2.LINE_AA)
    return out


def display_comparison(result, path: str | Path | None = None, *, image=None, show: bool = False) -> np.ndarray:
    """Side-by-side input / probability mask / binary mask / extracted board
    / predicted position of a ``ChessVisionResult``, composed with numpy and
    cv2 into one uint8 BGR image of (TITLE + PANEL) × (n·PANEL + (n−1)·GAP)
    for n panels: 2, plus the input when ``image`` is given, plus the board
    and the position when one was found.  Written to ``path`` (a PNG) when
    given and returned; ``show=True`` also displays it with matplotlib (the
    JAX package returns the matplotlib figure)."""
    import cv2

    board = result.board_extraction
    panels = []
    if image is not None:
        panels.append(_panel(np.asarray(image, np.uint8), "input"))
    # .probabilities holds the raw logits: squash them for the panel
    probs = 1.0 / (1.0 + np.exp(-np.asarray(board.probabilities, np.float32)))
    heat = cv2.applyColorMap(np.round(probs * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)
    panels.append(_panel(heat, "segmentation probabilities"))
    panels.append(_panel(np.asarray(board.binary_mask, np.uint8), "binary mask"))
    if result.position is not None:
        panels.append(_panel(np.asarray(board.board_image, np.uint8), "extracted board"))
        panels.append(_panel(render_board(result.position.fen), result.position.fen.split("/")[0] + "..."))
    gap = np.full((TITLE + PANEL, GAP, 3), 255, np.uint8)
    row = [panels[0]]
    for p in panels[1:]:
        row += [gap, p]
    composed = np.concatenate(row, axis=1)
    if path is not None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), composed)
    if show:  # pragma: no cover — interactive sessions only
        import matplotlib.pyplot as plt

        plt.figure(figsize=(composed.shape[1] / 100, composed.shape[0] / 100))
        plt.imshow(composed[..., ::-1])
        plt.axis("off")
        plt.show()
    return composed
