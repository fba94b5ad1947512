"""Reader of the repo's ``.npz`` checkpoints.

The format is a flat ``.npz`` of the Flax variable tree (``params/...``,
``batch_stats/...``) plus a JSON ``__metadata__`` entry.  float16 is a
storage format and is read back as float32.  The reader returns plain
numpy; ``weights.flax_to_torch`` turns it into a torch ``state_dict``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

Metadata = dict[str, Any]
VariableTree = dict[str, Any]

_META_KEY = "__metadata__"


def _unflatten(flat: dict[str, np.ndarray]) -> VariableTree:
    tree: VariableTree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str | Path) -> tuple[VariableTree, Metadata]:
    """Load an ``.npz`` checkpoint: (variable tree of numpy, metadata)."""
    with np.load(Path(path), allow_pickle=False) as data:
        flat = {}
        for k in data.files:
            if k == _META_KEY:
                continue
            v = data[k]
            flat[k] = v.astype(np.float32) if v.dtype == np.float16 else v
        metadata: Metadata = {}
        if _META_KEY in data.files:
            metadata = json.loads(bytes(data[_META_KEY].tolist()).decode("utf-8"))
    return _unflatten(flat), metadata


def load_variables(path: str | Path) -> tuple[VariableTree, Metadata]:
    """Inference view of a checkpoint: optimizer state dropped, and an EMA
    view (``ema_params``), where the trainer stored one, promoted to
    ``params``."""
    variables, metadata = load_checkpoint(path)
    variables.pop("opt_state", None)
    ema = variables.pop("ema_params", None)
    if ema is not None:
        variables["params"] = ema
    return variables, metadata
