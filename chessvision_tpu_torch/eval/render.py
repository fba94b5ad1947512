"""Board rendering for evaluation artifacts, the counterpart of
``chessvision_tpu/eval/render.py``.

``render_board_png`` draws a FEN as colored squares with piece letters in
numpy and writes it with cv2 (the GPU machine has cv2 and no matplotlib;
the JAX package draws unicode glyphs with matplotlib).  ``display_comparison``,
the notebook helper, still uses matplotlib and imports it when called.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from chessvision_tpu_torch.chessboard import expand_fen

LIGHT = (181, 217, 240)  # BGR of #f0d9b5
DARK = (99, 136, 181)  # BGR of #b58863


def render_board_png(fen: str, path: str | Path, size: int = 400) -> Path:
    """Render a board FEN to a PNG file: white pieces as dark-outlined
    white letters, black pieces as black letters."""
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
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), img)
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


def display_comparison(result, path: str | Path | None = None, *, image=None, show: bool = False):
    """Side-by-side input / probability mask / binary mask / extracted board
    / predicted position of a ``ChessVisionResult``; saved to ``path`` when
    given; returns the matplotlib figure."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    board = result.board_extraction
    base = 2 + (1 if image is not None else 0)
    n = base + (2 if result.position is not None else 0)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    col = 0
    if image is not None:
        axes[col].imshow(np.asarray(image)[..., ::-1])  # BGR → RGB
        axes[col].set_title("input")
        col += 1
    # .probabilities holds the raw logits: squash them for the panel
    axes[col].imshow(1.0 / (1.0 + np.exp(-np.asarray(board.probabilities, np.float32))), cmap="viridis", vmin=0.0, vmax=1.0)
    axes[col].set_title("segmentation probabilities")
    axes[col + 1].imshow(board.binary_mask, cmap="gray")
    axes[col + 1].set_title("binary mask")
    if result.position is not None:
        import tempfile

        import cv2

        axes[col + 2].imshow(board.board_image, cmap="gray")
        axes[col + 2].set_title("extracted board")
        with tempfile.TemporaryDirectory() as tmp:
            png = render_board_png(result.position.fen, Path(tmp) / "board.png")
            axes[col + 3].imshow(cv2.imread(str(png))[..., ::-1])
        axes[col + 3].set_title(result.position.fen.split("/")[0] + "…")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if path is not None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(p, bbox_inches="tight")
    if show:  # pragma: no cover — interactive sessions only
        plt.show()
    else:
        plt.close(fig)
    return fig
