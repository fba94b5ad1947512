"""The repo's ``.npz`` checkpoints, read and written.

The format is a flat ``.npz`` of the Flax variable tree (``params/...``,
``batch_stats/...``, optionally ``ema_params/...``) plus a JSON
``__metadata__`` entry, and, in a training checkpoint, the optimizer state
as ``opt_state/leafNNNN``: optax's leaves in ``jax.tree.leaves`` order (the
trainers' optimizers keep that order, ``train/steps.py``).  float16 is a
storage format and is read back as float32.  Both packages read and write
the same files, so a run started in one resumes in the other.  The module
deals in numpy; ``weights.flax_to_torch`` / ``torch_to_flax`` convert.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

Metadata = dict[str, Any]
VariableTree = dict[str, Any]

_META_KEY = "__metadata__"


def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


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


def save_checkpoint(
    path: str | Path,
    variables: VariableTree,
    metadata: Metadata | None = None,
    opt_state: list[np.ndarray] | None = None,
) -> None:
    """Save a variable tree (``params``, ``batch_stats``, ...) of numpy with
    metadata to ``path`` (.npz).  ``opt_state`` is the optimizer's leaf
    list, stored as ``opt_state/leafNNNN``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = dict(variables)
    if opt_state is not None:
        tree["opt_state"] = {f"leaf{i:04d}": np.asarray(leaf) for i, leaf in enumerate(opt_state)}
    flat = _flatten(tree)
    flat[_META_KEY] = np.frombuffer(json.dumps(metadata or {}).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def load_opt_state_leaves(variables: VariableTree) -> list[np.ndarray] | None:
    """The saved optimizer leaves in order, or None."""
    opt = variables.get("opt_state")
    if not opt:
        return None
    return [opt[k] for k in sorted(opt)]


def load_metadata(path: str | Path) -> Metadata:
    """Only a checkpoint's metadata dict (empty if absent); the arrays are
    not read."""
    with np.load(Path(path), allow_pickle=False) as data:
        if _META_KEY not in data.files:
            return {}
        return json.loads(bytes(data[_META_KEY].tolist()).decode("utf-8"))


def promote_checkpoint(src: str | Path, dest: str | Path, compress: bool = True) -> Path:
    """Copy a training checkpoint to a weights path: optimizer state
    dropped, an EMA view (``ema_params``) shipped as ``params``, and with
    ``compress`` the float32 params stored as float16 (BatchNorm running
    statistics stay float32)."""
    variables, metadata = load_variables(src)
    if compress:
        def shrink(tree: dict[str, Any]) -> dict[str, Any]:
            return {
                k: shrink(v) if isinstance(v, dict) else (v.astype(np.float16) if v.dtype == np.float32 else v)
                for k, v in tree.items()
            }

        variables["params"] = shrink(variables["params"])
    save_checkpoint(dest, variables, metadata)
    return Path(dest)


def strip_checkpoint(path: str | Path, out_path: str | Path | None = None) -> Path:
    """Remove the optimizer state from a checkpoint."""
    variables, metadata = load_checkpoint(path)
    variables.pop("opt_state", None)
    out = Path(out_path or path)
    save_checkpoint(out, variables, metadata)
    return out
