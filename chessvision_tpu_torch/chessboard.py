"""FEN assembly and parsing (host string work).

The port's copy of ``labels_to_fen``, ``fen_to_labels`` and ``expand_fen``
from ``chessvision_tpu/chessboard.py``.  Square 0 is a1, square 63 is h8,
as in python-chess.
"""

from __future__ import annotations

FILES = "abcdefgh"
RANKS = "12345678"

SQUARE_NAMES = [f + r for r in RANKS for f in FILES]
SQUARE_INDICES = {name: idx for idx, name in enumerate(SQUARE_NAMES)}

PIECE_SYMBOLS = set("PNBRQKpnbrqk")


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


def fen_to_labels(fen: str) -> list[str]:
    """Convert a board FEN to 64 labels in FEN order (a8-h8, ..., a1-h1),
    'f' for empty squares; raises ``ValueError`` on a malformed FEN."""
    fen = fen.strip().split()[0]
    rows = fen.split("/")
    if len(rows) != 8:
        raise ValueError(f"Invalid board FEN: {fen!r}")
    labels: list[str] = []
    for row in rows:
        start = len(labels)
        for ch in row:
            if ch.isdigit():
                labels.extend("f" * int(ch))
            elif ch in PIECE_SYMBOLS:
                labels.append(ch)
            else:
                raise ValueError(f"Invalid FEN character: {ch!r}")
        if len(labels) - start != 8:
            raise ValueError(f"Invalid board FEN row: {row!r}")
    return labels


def expand_fen(fen: str) -> str:
    """Expand a board FEN into a 64-character string (dots for empties),
    top-left (a8) first, as the web client's expandFen does."""
    out = []
    for row in fen.split("/"):
        for ch in row:
            out.append("." * int(ch) if ch.isdigit() else ch)
    return "".join(out)
