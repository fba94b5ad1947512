"""Input pipelines over the checked-in datasets: the port's copy of
``chessvision_tpu/train/data.py``.

Host-RAM-resident arrays and a deterministic shuffling iterator: the
fixture datasets (631 seg pairs ≈ 124 MB, ~11k squares ≈ 45 MB) fit in
memory, so the input pipeline is an array plus index shuffling.  The
index batches come from the same ``np.random.Generator`` calls as the JAX
package's, so both trainers see the same batches in the same order.

Split semantics follow the reference: 90/10 train/val with a fixed seed
(create_board_extraction_tables.py:44-48); squares use the checked-in
training/ and validation/ folders whose sorted class-dir order matches
LABEL_NAMES (data/squares/README.md).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from chessvision_tpu_torch import constants

logger = logging.getLogger(__name__)

VAL_SPLIT_PERCENT = 0.1  # reference scripts/train/config.py:25
SPLIT_SEED = 0  # reference create_board_extraction_tables.py:44-48


def _imread(path: Path, gray: bool = False) -> np.ndarray | None:
    import cv2

    flags = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    return cv2.imread(str(path), flags)


_IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


def _image_files(directory: Path) -> list[Path]:
    """Sorted image files, case-insensitive extensions (the fixture dirs
    mix .JPG and .jpg)."""
    return sorted(p for p in directory.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES)


@dataclass
class SegmentationData:
    train_images: np.ndarray  # (N, 256, 256, 3) uint8 BGR
    train_masks: np.ndarray  # (N, 256, 256) float32 in {0, 1}
    val_images: np.ndarray
    val_masks: np.ndarray
    train_ids: list[str]
    val_ids: list[str]


def load_board_extraction(
    data_root: str | Path | None = None,
    val_split: float = VAL_SPLIT_PERCENT,
    seed: int = SPLIT_SEED,
) -> SegmentationData:
    root = Path(data_root or constants.data_root()) / "board_extraction"
    image_dir, mask_dir = root / "images", root / "masks"
    ids, images, masks = [], [], []
    for img_path in _image_files(image_dir):
        mask_path = mask_dir / (img_path.stem + ".png")
        img = _imread(img_path)
        mask = _imread(mask_path, gray=True)
        if img is None or mask is None:
            continue
        if img.shape[:2] != (256, 256):
            import cv2

            img = cv2.resize(img, (256, 256), interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (256, 256), interpolation=cv2.INTER_NEAREST)
        ids.append(img_path.stem)
        images.append(img)
        masks.append((mask > 127).astype(np.float32))
    images_a = np.stack(images)
    masks_a = np.stack(masks)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    n_val = max(1, int(round(len(ids) * val_split)))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    logger.info("board_extraction: %d train / %d val", len(train_idx), len(val_idx))
    return SegmentationData(
        train_images=images_a[train_idx],
        train_masks=masks_a[train_idx],
        val_images=images_a[val_idx],
        val_masks=masks_a[val_idx],
        train_ids=[ids[i] for i in train_idx],
        val_ids=[ids[i] for i in val_idx],
    )


@dataclass
class ClassificationData:
    train_images: np.ndarray  # (N, 64, 64) uint8 grayscale
    train_labels: np.ndarray  # (N,) int32
    val_images: np.ndarray
    val_labels: np.ndarray
    train_ids: list[str]
    val_ids: list[str]
    class_names: list[str]


def load_image_mask_dir(root: str | Path) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Load an images/ + masks/ pair directory in the board_extraction
    layout (256² BGR images, binary masks) — extra curated or synthetic
    training batches (e.g. scripts/make_screen_boards.py) appended to the
    TRAIN side only via train_unet's ``--extra-data``."""
    root = Path(root)
    image_dir, mask_dir = root / "images", root / "masks"
    if not image_dir.is_dir() or not mask_dir.is_dir():
        raise ValueError(f"{root} is not an images/+masks/ pair directory")
    ids, images, masks = [], [], []
    for img_path in _image_files(image_dir):
        mask_path = mask_dir / (img_path.stem + ".png")
        img = _imread(img_path)
        mask = _imread(mask_path, gray=True)
        if img is None or mask is None:
            continue
        if img.shape[:2] != (256, 256):
            import cv2

            img = cv2.resize(img, (256, 256), interpolation=cv2.INTER_AREA)
            mask = cv2.resize(mask, (256, 256), interpolation=cv2.INTER_NEAREST)
        ids.append(img_path.stem)
        images.append(img)
        masks.append((mask > 127).astype(np.float32))
    if not ids:
        raise ValueError(f"no image/mask pairs under {root}")
    return np.stack(images), np.stack(masks), ids


def load_squares_dir(
    root: str | Path, class_names: list[str]
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Load one extra ImageFolder of 64² gray squares (13 class dirs in the
    squares/ layout) mapped onto an EXISTING ``class_names`` order — extra
    mined or curated batches (e.g. scripts/mine_warped_squares.py) appended
    to the TRAIN side only via train_classifier's ``--extra-data``.
    Unknown class dirs fail loudly rather than silently shifting labels."""
    root = Path(root)
    if not root.is_dir():
        raise ValueError(f"{root} is not a directory")
    index = {name: i for i, name in enumerate(class_names)}
    images, labels, ids = [], [], []
    for cd in sorted(d for d in root.iterdir() if d.is_dir()):
        if cd.name not in index:
            raise ValueError(f"{cd} is not one of the dataset's classes {class_names}")
        for p in _image_files(cd):
            img = _imread(p, gray=True)
            if img is None:
                continue
            if img.shape != (64, 64):
                import cv2

                img = cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA)
            images.append(img)
            labels.append(index[cd.name])
            ids.append(f"{cd.name}/{p.name}")
    if not ids:
        raise ValueError(f"no class-dir images under {root}")
    return np.stack(images), np.asarray(labels, np.int32), ids


def load_squares(data_root: str | Path | None = None) -> ClassificationData:
    root = Path(data_root or constants.data_root()) / "squares"

    def load_split(split: str) -> tuple[np.ndarray, np.ndarray, list[str], list[str]]:
        split_dir = root / split
        class_dirs = sorted(d for d in split_dir.iterdir() if d.is_dir())
        images, labels, ids = [], [], []
        for ci, cd in enumerate(class_dirs):
            for p in _image_files(cd):
                img = _imread(p, gray=True)
                if img is None:
                    continue
                if img.shape != (64, 64):
                    import cv2

                    img = cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA)
                images.append(img)
                labels.append(ci)
                ids.append(f"{cd.name}/{p.name}")
        return np.stack(images), np.asarray(labels, np.int32), ids, [d.name for d in class_dirs]

    tr_x, tr_y, tr_ids, class_names = load_split("training")
    va_x, va_y, va_ids, _ = load_split("validation")
    logger.info("squares: %d train / %d val, classes %s", len(tr_y), len(va_y), class_names)
    return ClassificationData(
        train_images=tr_x,
        train_labels=tr_y,
        val_images=va_x,
        val_labels=va_y,
        train_ids=tr_ids,
        val_ids=va_ids,
        class_names=class_names,
    )


def pad_indices(idx: np.ndarray, batch_size: int) -> tuple[np.ndarray, int]:
    """Pad an index batch to a fixed size by repeating the last index.

    Keeps every eval/collection batch at one shape, as in the JAX
    package.  Returns (padded_indices, real_count)."""
    n = len(idx)
    if n == batch_size:
        return idx, n
    pad = np.full(batch_size - n, idx[-1], dtype=idx.dtype)
    return np.concatenate([idx, pad]), n


def batches(
    n: int,
    batch_size: int,
    *,
    rng: np.random.Generator | None = None,
    weights: np.ndarray | None = None,
    drop_last: bool = False,
) -> Iterator[np.ndarray]:
    """Index batches: shuffled when rng is given; weighted sampling with
    replacement when weights is given (the reference's 3LC sample-weight
    sampler, train_unet.py:189)."""
    if weights is not None:
        assert rng is not None
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
        idx = rng.choice(n, size=n, replace=True, p=p)
    elif rng is not None:
        idx = rng.permutation(n)
    else:
        idx = np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        yield idx[i : i + batch_size]
