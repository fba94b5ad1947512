"""Constants of the PyTorch port: sizes, label tables, square names.

The port's own copy of the values the image→FEN path needs from
``chessvision_tpu/constants.py`` (same label order, sizes and square
tables, so results compare one to one), and of its roots: ``REPO_ROOT`` is
``CVTPU_ROOT`` when set, else the checkout, and the weights and the run
store's default root follow it; the datasets resolve as in the JAX
package (``data_root``).
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_ROOT = Path(os.getenv("CVTPU_ROOT", Path(__file__).resolve().parent.parent.as_posix()))


def data_root() -> Path:
    """The dataset root, read when called, in the JAX package's order:
    ``CVTPU_DATA_ROOT``, else ``<root>/data`` if it exists, else the data
    tree of the read-only reference checkout if that exists, else
    ``<root>/data``."""
    env = os.getenv("CVTPU_DATA_ROOT")
    if env:
        return Path(env)
    local = REPO_ROOT / "data"
    if local.exists():
        return local
    reference = Path("/root/reference/data")
    if reference.exists():
        return reference
    return local


DATA_ROOT = data_root()

NUM_CLASSES = 13

# Image sizes (width, height)
INPUT_SIZE = (256, 256)
BOARD_SIZE = (512, 512)
PIECE_SIZE = (64, 64)

# Label order of the classifier's 13 outputs ('f' = empty square).
LABEL_NAMES = ["B", "K", "N", "P", "Q", "R", "b", "k", "n", "p", "q", "r", "f"]
LABEL_INDICES = {label: idx for idx, label in enumerate(LABEL_NAMES)}

WEIGHTS_DIR = REPO_ROOT / "weights"
BEST_EXTRACTOR_WEIGHTS = str(WEIGHTS_DIR / "best_extractor.npz")
BEST_CLASSIFIER_WEIGHTS = str(WEIGHTS_DIR / "best_classifier.npz")
BEST_YOLO_EXTRACTOR = str(WEIGHTS_DIR / "best_yolo_extractor.npz")
BEST_YOLO_CLASSIFIER = str(WEIGHTS_DIR / "best_yolo_classifier.npz")

INVALID_PAWN_SQUARES = {
    "a1", "b1", "c1", "d1", "e1", "f1", "g1", "h1",
    "a8", "b8", "c8", "d8", "e8", "f8", "g8", "h8",
}

# Square names in model output order for both orientations.
# Normal: the first extracted square (top-left of the rectified board) is a8.
# fmt: off
SQUARE_NAMES_NORMAL = [
    "a8", "b8", "c8", "d8", "e8", "f8", "g8", "h8",
    "a7", "b7", "c7", "d7", "e7", "f7", "g7", "h7",
    "a6", "b6", "c6", "d6", "e6", "f6", "g6", "h6",
    "a5", "b5", "c5", "d5", "e5", "f5", "g5", "h5",
    "a4", "b4", "c4", "d4", "e4", "f4", "g4", "h4",
    "a3", "b3", "c3", "d3", "e3", "f3", "g3", "h3",
    "a2", "b2", "c2", "d2", "e2", "f2", "g2", "h2",
    "a1", "b1", "c1", "d1", "e1", "f1", "g1", "h1",
]

SQUARE_NAMES_FLIPPED = [
    "h1", "g1", "f1", "e1", "d1", "c1", "b1", "a1",
    "h2", "g2", "f2", "e2", "d2", "c2", "b2", "a2",
    "h3", "g3", "f3", "e3", "d3", "c3", "b3", "a3",
    "h4", "g4", "f4", "e4", "d4", "c4", "b4", "a4",
    "h5", "g5", "f5", "e5", "d5", "c5", "b5", "a5",
    "h6", "g6", "f6", "e6", "d6", "c6", "b6", "a6",
    "h7", "g7", "f7", "e7", "d7", "c7", "b7", "a7",
    "h8", "g8", "f8", "e8", "d8", "c8", "b8", "a8",
]
# fmt: on

# the dark squares of the board (a1 is dark)
DARK_SQUARES = {
    "a1", "c1", "e1", "g1",
    "b2", "d2", "f2", "h2",
    "a3", "c3", "e3", "g3",
    "b4", "d4", "f4", "h4",
    "a5", "c5", "e5", "g5",
    "b6", "d6", "f6", "h6",
    "a7", "c7", "e7", "g7",
    "b8", "d8", "f8", "h8",
}
