"""Dataset curation utilities, the counterpart of
``chessvision_tpu/curation.py``, over the port's runstore tables:

- ``scan_image_issues``: per-image quality flags (dark / bright /
  low-contrast / blurry / near-duplicate), computed with numpy (blur via
  Laplacian variance, duplicates via difference hashes);
- ``create_subset``: a filtered table revision from issue flags or any
  predicate (with lineage);
- ``ingest_edited_masks``: fold externally edited masks back into a
  segmentation table revision.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from chessvision_tpu_torch.runstore import Table

logger = logging.getLogger(__name__)


def _laplacian_var(gray: np.ndarray) -> float:
    """Blur metric: variance of the 4-neighbour Laplacian."""
    g = gray.astype(np.float32)
    lap = -4 * g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]
    return float(lap.var())


def _dhash(gray: np.ndarray, size: int = 8) -> int:
    """Difference hash for near-duplicate detection."""
    import cv2

    small = cv2.resize(gray, (size + 1, size), interpolation=cv2.INTER_AREA)
    bits = (small[:, 1:] > small[:, :-1]).flatten()
    return int("".join("1" if b else "0" for b in bits), 2)


def scan_image_issues(
    paths: list[str | Path],
    *,
    dark_threshold: float = 45.0,
    bright_threshold: float = 210.0,
    contrast_threshold: float = 25.0,
    blur_threshold: float = 40.0,
    duplicate_hamming: int = 4,
) -> dict[str, np.ndarray]:
    """Per-image issue flags + raw metrics for a list of image paths."""
    import cv2

    n = len(paths)
    brightness = np.zeros(n, np.float32)
    contrast = np.zeros(n, np.float32)
    blur = np.zeros(n, np.float32)
    hashes: list[int] = []
    ok = np.ones(n, bool)

    for i, p in enumerate(paths):
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            ok[i] = False
            hashes.append(-1)
            continue
        brightness[i] = float(img.mean())
        contrast[i] = float(img.std())
        blur[i] = _laplacian_var(img)
        hashes.append(_dhash(img))

    # near-duplicates: hamming distance over dhash
    dup = np.zeros(n, bool)
    seen: list[tuple[int, int]] = []
    for i, h in enumerate(hashes):
        if h < 0:
            continue
        for j, hj in seen:
            if bin(h ^ hj).count("1") <= duplicate_hamming:
                dup[i] = True
                break
        seen.append((i, h))

    return {
        "path": np.asarray([str(p) for p in paths], object),
        "readable": ok,
        "brightness": brightness,
        "contrast": contrast,
        "blur_score": blur,
        "is_dark": ok & (brightness < dark_threshold),
        "is_bright": ok & (brightness > bright_threshold),
        "is_low_contrast": ok & (contrast < contrast_threshold),
        "is_blurry": ok & (blur < blur_threshold),
        "is_near_duplicate": dup,
    }


def attach_issue_scan(table: Table, path_column: str = "path") -> Table:
    """Run the issue scan over a table's image paths and attach the flag
    columns in place."""
    issues = scan_image_issues(list(table[path_column]))
    for key, values in issues.items():
        if key == "path":
            continue
        table.with_column(key, values)
    return table


def create_subset(
    table: Table,
    name: str,
    *,
    drop_issues: bool = True,
    predicate=None,
) -> Table:
    """Filtered table revision: drop flagged rows and/or apply a predicate."""
    mask = np.ones(len(table), bool)
    if drop_issues:
        for col in ("is_dark", "is_bright", "is_low_contrast", "is_blurry", "is_near_duplicate"):
            if col in table.columns:
                mask &= ~np.asarray(table[col], bool)
        if "readable" in table.columns:
            mask &= np.asarray(table["readable"], bool)
    if predicate is not None:
        mask &= np.asarray([bool(predicate(r)) for r in table.rows()])
    subset = table.select(np.nonzero(mask)[0], name)
    logger.info("Subset %s: %d -> %d rows", name, len(table), len(subset))
    return subset


def ingest_edited_masks(
    table: Table,
    edited_mask_dir: str | Path,
    name: str,
    *,
    id_column: str = "example_id",
    mask_column: str = "mask",
) -> Table:
    """Create a table revision whose mask column is replaced by edited
    masks found in ``edited_mask_dir`` (matched by example id stem)."""
    import cv2

    edited = {p.stem: p for p in Path(edited_mask_dir).glob("*.png")}
    masks = np.asarray(table[mask_column]).copy()
    replaced = 0
    for i, ex_id in enumerate(table[id_column]):
        stem = str(ex_id).split(":")[-1].split("/")[-1]
        if stem in edited:
            m = cv2.imread(str(edited[stem]), cv2.IMREAD_GRAYSCALE)
            if m is None:
                continue
            if m.shape != masks[i].shape:
                m = cv2.resize(m, masks[i].shape[::-1], interpolation=cv2.INTER_NEAREST)
            masks[i] = (m > 127).astype(masks.dtype) * (255 if masks.dtype == np.uint8 else 1)
            replaced += 1
    out = table.with_column(mask_column, masks, name)
    out.lineage["edited_masks"] = replaced
    logger.info("Ingested %d edited masks into %s", replaced, out.url)
    return out
