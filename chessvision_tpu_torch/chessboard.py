"""FEN assembly from per-square labels (host string work).

The port's copy of ``labels_to_fen`` from ``chessvision_tpu/chessboard.py``.
Square 0 is a1, square 63 is h8, as in python-chess.
"""

from __future__ import annotations

FILES = "abcdefgh"
RANKS = "12345678"

SQUARE_NAMES = [f + r for r in RANKS for f in FILES]
SQUARE_INDICES = {name: idx for idx, name in enumerate(SQUARE_NAMES)}


def labels_to_fen(labels: list[str], square_names: list[str]) -> str:
    """Build a board FEN from 64 piece labels ('f' = empty) aligned with
    ``square_names``."""
    pieces: list[str | None] = [None] * 64
    for label, name in zip(labels, square_names):
        if label != "f":
            pieces[SQUARE_INDICES[name]] = label
    rows = []
    for rank in range(7, -1, -1):
        row = ""
        empty = 0
        for file in range(8):
            sym = pieces[rank * 8 + file]
            if sym is None:
                empty += 1
                continue
            if empty:
                row += str(empty)
                empty = 0
            row += sym
        if empty:
            row += str(empty)
        rows.append(row)
    return "/".join(rows)
