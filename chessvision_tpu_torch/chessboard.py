"""FEN assembly and parsing (host string work).

The port's copy of ``chessvision_tpu/chessboard.py``: ``Piece`` and
``BaseBoard`` (the subset of python-chess the reference uses: placement
from per-square predictions, ``board_fen``, piece maps), and the hot-path
helpers ``labels_to_fen``, ``fen_to_labels`` and ``expand_fen``.  Square 0
is a1, square 63 is h8, as in python-chess.
"""

from __future__ import annotations

from dataclasses import dataclass

FILES = "abcdefgh"
RANKS = "12345678"

SQUARE_NAMES = [f + r for r in RANKS for f in FILES]
SQUARE_INDICES = {name: idx for idx, name in enumerate(SQUARE_NAMES)}

PIECE_SYMBOLS = set("PNBRQKpnbrqk")


@dataclass(frozen=True)
class Piece:
    """A chess piece identified by its FEN symbol (e.g. 'P', 'q')."""

    symbol: str

    def __post_init__(self) -> None:
        if self.symbol not in PIECE_SYMBOLS:
            raise ValueError(f"Invalid piece symbol: {self.symbol!r}")

    @classmethod
    def from_symbol(cls, symbol: str) -> "Piece":
        return cls(symbol)

    def __str__(self) -> str:
        return self.symbol


class BaseBoard:
    """Piece placement only (no side-to-move/castling state), like
    ``chess.BaseBoard``.  Constructing with ``board_fen=None`` yields an empty
    board (reference core.py:330)."""

    def __init__(self, board_fen: str | None = None):
        self._pieces: list[str | None] = [None] * 64
        if board_fen is not None:
            self._set_board_fen(board_fen)

    @classmethod
    def empty(cls) -> "BaseBoard":
        return cls(None)

    def _set_board_fen(self, fen: str) -> None:
        fen = fen.strip().split()[0]
        rows = fen.split("/")
        if len(rows) != 8:
            raise ValueError(f"Invalid board FEN: {fen!r}")
        for rank_from_top, row in enumerate(rows):
            rank = 7 - rank_from_top
            file = 0
            for ch in row:
                if ch.isdigit():
                    file += int(ch)
                elif ch in PIECE_SYMBOLS:
                    if file > 7:
                        raise ValueError(f"Invalid board FEN row: {row!r}")
                    self._pieces[rank * 8 + file] = ch
                    file += 1
                else:
                    raise ValueError(f"Invalid FEN character: {ch!r}")
            if file != 8:
                raise ValueError(f"Invalid board FEN row: {row!r}")

    def set_piece_at(self, square: int, piece: Piece | None, promoted: bool = False) -> None:
        self._pieces[square] = None if piece is None else piece.symbol

    def piece_at(self, square: int) -> Piece | None:
        sym = self._pieces[square]
        return None if sym is None else Piece(sym)

    def piece_map(self) -> dict[int, Piece]:
        return {sq: Piece(sym) for sq, sym in enumerate(self._pieces) if sym is not None}

    def board_fen(self, promoted: bool = False) -> str:
        rows = []
        for rank in range(7, -1, -1):
            row = ""
            empty = 0
            for file in range(8):
                sym = self._pieces[rank * 8 + file]
                if sym is None:
                    empty += 1
                else:
                    if empty:
                        row += str(empty)
                        empty = 0
                    row += sym
            if empty:
                row += str(empty)
            rows.append(row)
        return "/".join(rows)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BaseBoard) and self._pieces == other._pieces


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
