"""Dataset table registration — the reference's table-builder layer.

create_board_extraction_tables.py / create_classification_tables.py wrap
the raw datasets into persistent 3LC tables with a seeded split and reuse
them via get_or_create (reference create_board_extraction_tables.py:82-109).
Here the same capability on runstore tables: one row per example (paths +
labels + ids), deterministic 90/10 split recorded as table lineage, and a
``sample_weight`` column the trainers consume for weighted sampling.
Pixels stay on disk — tables carry references, the in-memory pipelines
(train/data.py) carry the arrays.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.runstore import Table
from chessvision_tpu_torch.train.data import (
    SPLIT_SEED,
    VAL_SPLIT_PERCENT,
    _image_files,
)

logger = logging.getLogger(__name__)

SEG_PROJECT = "chessvision-segmentation"
CLS_PROJECT = "chessvision-classification"


def get_or_create_board_extraction_tables(
    train_name: str = "initial-train",
    val_name: str = "initial-val",
    data_root: str | Path | None = None,
) -> dict[str, Table]:
    """Register (or load) the segmentation train/val tables with the
    reference's seeded 90/10 split."""
    if Table.exists(SEG_PROJECT, "board_extraction", train_name) and Table.exists(
        SEG_PROJECT, "board_extraction", val_name
    ):
        return {
            "train": Table.load(SEG_PROJECT, "board_extraction", train_name),
            "val": Table.load(SEG_PROJECT, "board_extraction", val_name),
        }

    root = Path(data_root or constants.data_root()) / "board_extraction"
    rows = []
    for img in _image_files(root / "images"):
        mask = root / "masks" / (img.stem + ".png")
        if mask.exists():
            rows.append((img.stem, str(img), str(mask)))
    base = Table(
        SEG_PROJECT,
        "board_extraction",
        "initial",
        {
            "example_id": np.asarray([r[0] for r in rows], object),
            "image_path": np.asarray([r[1] for r in rows], object),
            "mask_path": np.asarray([r[2] for r in rows], object),
            "sample_weight": np.ones(len(rows)),
        },
    ).save()
    train, val = base.split(VAL_SPLIT_PERCENT, SPLIT_SEED, (train_name, val_name))
    train.save()
    val.save()
    logger.info("Registered seg tables: %d train / %d val", len(train), len(val))
    return {"train": train, "val": val}


def get_or_create_classification_tables(
    train_name: str = "initial-train",
    val_name: str = "initial-val",
    data_root: str | Path | None = None,
) -> dict[str, Table]:
    """Register (or load) the squares train/val tables (checked-in folder
    split, class order == LABEL_NAMES)."""
    if Table.exists(CLS_PROJECT, "squares", train_name) and Table.exists(
        CLS_PROJECT, "squares", val_name
    ):
        return {
            "train": Table.load(CLS_PROJECT, "squares", train_name),
            "val": Table.load(CLS_PROJECT, "squares", val_name),
        }

    root = Path(data_root or constants.data_root()) / "squares"
    out = {}
    for split, name in (("training", train_name), ("validation", val_name)):
        split_dir = root / split
        class_dirs = sorted(d for d in split_dir.iterdir() if d.is_dir())
        ids, paths, labels = [], [], []
        for ci, cd in enumerate(class_dirs):
            for p in _image_files(cd):
                ids.append(f"{cd.name}/{p.name}")
                paths.append(str(p))
                labels.append(ci)
        t = Table(
            CLS_PROJECT,
            "squares",
            name,
            {
                "example_id": np.asarray(ids, object),
                "image_path": np.asarray(paths, object),
                "label": np.asarray(labels, np.int64),
                "sample_weight": np.ones(len(ids)),
            },
        ).save()
        out["train" if split == "training" else "val"] = t
    logger.info(
        "Registered cls tables: %d train / %d val", len(out["train"]), len(out["val"])
    )
    return out


def sample_weights_for_ids(table: Table, ids: list[str]) -> np.ndarray | None:
    """Per-example weights aligned to ``ids`` from a table's sample_weight
    column (None when uniform) — the bridge between curation (which edits
    weights on table revisions) and the trainers."""
    if "sample_weight" not in table.columns:
        return None
    lookup = {e: float(w) for e, w in zip(table["example_id"], table["sample_weight"])}
    w = np.asarray([lookup.get(i, 1.0) for i in ids], np.float64)
    if np.allclose(w, w[0] if len(w) else 1.0):
        return None
    return w
