"""The repo's ``.npz`` checkpoints, read and written.

The format is a flat ``.npz`` of the Flax variable tree (``params/...``,
``batch_stats/...``, optionally ``ema_params/...``) plus a JSON
``__metadata__`` entry, and, in a training checkpoint, the optimizer state
as ``opt_state/leafNNNN``: optax's leaves in ``jax.tree.leaves`` order (the
trainers' optimizers keep that order, ``train/steps.py``).  float16 is a
storage format and is read back as float32.  Both packages read and write
the same files, so a run started in one resumes in the other.  The module
deals in numpy; ``weights.flax_to_torch`` / ``torch_to_flax`` convert.

``load_checkpoint`` also reads the reference implementation's PyTorch
``.pth`` files (a milesial UNet or a torchvision/timm ResNet18 state
dict), converted to the same Flax variable tree the JAX package makes of
them (``load_torch_checkpoint``).
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
    """Load a checkpoint: (variable tree of numpy, metadata).  ``.npz`` is
    the repo's format; ``.pth``/``.pt`` the reference's."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        return load_torch_checkpoint(path)
    with np.load(path, allow_pickle=False) as data:
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
    """Only a checkpoint's metadata dict (empty if absent); the arrays of
    an ``.npz`` are not read."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        return load_torch_checkpoint(path)[1]
    with np.load(path, allow_pickle=False) as data:
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


# --- the reference's .pth files -------------------------------------------------


def _torch_state_dict(path: Path) -> tuple[dict[str, np.ndarray], Metadata]:
    import torch

    # the reference's files wrap the state dict with pickled metadata
    obj = torch.load(path, map_location="cpu", weights_only=False)
    metadata: Metadata = {}
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj:
                metadata = {k: v for k, v in obj.get("metadata", {}).items() if _jsonable(v)}
                obj = obj[key]
                break
    state = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in obj.items()}
    return state, metadata


def _jsonable(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch OIHW → Flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _convtranspose_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kH, kW) → Flax (kH, kW, in, out),
    flipped in space (Flax's transposed convolution correlates)."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def _bn_entries(state: dict[str, np.ndarray], torch_prefix: str) -> tuple[dict, dict]:
    params = {"scale": state[f"{torch_prefix}.weight"], "bias": state[f"{torch_prefix}.bias"]}
    stats = {"mean": state[f"{torch_prefix}.running_mean"], "var": state[f"{torch_prefix}.running_var"]}
    return params, stats


def _convert_double_conv(state: dict[str, np.ndarray], torch_prefix: str) -> tuple[dict, dict]:
    """milesial DoubleConv: Sequential(conv, bn, relu, conv, bn, relu),
    parameters at indices 0, 1, 3, 4."""
    params: dict[str, Any] = {"conv1": {"kernel": _conv_kernel(state[f"{torch_prefix}.0.weight"])}}
    stats: dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn_entries(state, f"{torch_prefix}.1")
    params["conv2"] = {"kernel": _conv_kernel(state[f"{torch_prefix}.3.weight"])}
    params["bn2"], stats["bn2"] = _bn_entries(state, f"{torch_prefix}.4")
    return params, stats


def convert_unet_state_dict(state: dict[str, np.ndarray]) -> VariableTree:
    """milesial UNet ``.pth`` state dict → the Flax UNet variable tree."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    params["inc"], stats["inc"] = _convert_double_conv(state, "inc.double_conv")
    for k in range(1, 5):
        p, s = _convert_double_conv(state, f"down{k}.maxpool_conv.1.double_conv")
        params[f"down{k}"], stats[f"down{k}"] = {"conv": p}, {"conv": s}
    bilinear = "up1.up.weight" not in state
    for k in range(1, 5):
        p, s = _convert_double_conv(state, f"up{k}.conv.double_conv")
        up_p: dict[str, Any] = {"conv": p}
        if not bilinear:
            up_p["up"] = {"kernel": _convtranspose_kernel(state[f"up{k}.up.weight"]), "bias": state[f"up{k}.up.bias"]}
        params[f"up{k}"], stats[f"up{k}"] = up_p, {"conv": s}
    params["outc"] = {"kernel": _conv_kernel(state["outc.conv.weight"]), "bias": state["outc.conv.bias"]}
    return {"params": params, "batch_stats": stats}


def convert_resnet_state_dict(state: dict[str, np.ndarray]) -> VariableTree:
    """timm/torchvision ResNet18 state dict → the Flax ResNet variable tree."""
    params: dict[str, Any] = {"conv1": {"kernel": _conv_kernel(state["conv1.weight"])}}
    stats: dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn_entries(state, "bn1")
    for i in range(1, 5):
        for j in range(2):
            tp, name = f"layer{i}.{j}", f"layer{i}_{j}"
            p: dict[str, Any] = {
                "conv1": {"kernel": _conv_kernel(state[f"{tp}.conv1.weight"])},
                "conv2": {"kernel": _conv_kernel(state[f"{tp}.conv2.weight"])},
            }
            s: dict[str, Any] = {}
            p["bn1"], s["bn1"] = _bn_entries(state, f"{tp}.bn1")
            p["bn2"], s["bn2"] = _bn_entries(state, f"{tp}.bn2")
            if f"{tp}.downsample.0.weight" in state:
                p["down_conv"] = {"kernel": _conv_kernel(state[f"{tp}.downsample.0.weight"])}
                p["down_bn"], s["down_bn"] = _bn_entries(state, f"{tp}.downsample.1")
            params[name], stats[name] = p, s
    params["fc"] = {"kernel": state["fc.weight"].T, "bias": state["fc.bias"]}
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str | Path) -> tuple[VariableTree, Metadata]:
    """A reference ``.pth`` checkpoint as a Flax variable tree, the UNet or
    the ResNet told apart by its keys."""
    state, metadata = _torch_state_dict(Path(path))
    if any(k.startswith("inc.") for k in state):
        return convert_unet_state_dict(state), metadata
    if "conv1.weight" in state and "layer1.0.conv1.weight" in state:
        return convert_resnet_state_dict(state), metadata
    raise ValueError(f"Unrecognized torch checkpoint layout: {sorted(state)[:5]} ...")
