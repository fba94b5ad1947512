"""Flax variable trees ↔ PyTorch ``state_dict``s.

The port's models name their submodules after the Flax modules, so a
Flax path maps to a torch key one to one
(``params/up1/conv/conv1/kernel`` → ``up1.conv.conv1.weight``):

- Conv kernel HWIO → OIHW;
- ConvTranspose kernel (kH, kW, in, out), spatially flipped against
  torch's → (in, out, kH, kW) with the flip undone (the inverse of
  ``chessvision_tpu/checkpoint.py:_convtranspose_kernel``);
- Dense kernel (in, out) → ``Linear.weight`` = kernel.T;
- BatchNorm ``scale``/``bias``/``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``.

``torch_to_flax`` is the exact inverse, and ``param_slots`` lists a model's
parameters in the order ``jax.tree.leaves`` gives the Flax ``params``
(sorted paths), with the layout change of each: the order and shapes of the
optimizer state in a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict[str, Any], prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    out: dict[tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def _convert(owner: nn.Module, leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if isinstance(owner, nn.ConvTranspose2d) and leaf == "kernel":
        return "weight", np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if isinstance(owner, nn.Conv2d) and leaf == "kernel":
        return "weight", np.transpose(value, (3, 2, 0, 1))
    if isinstance(owner, nn.Linear) and leaf == "kernel":
        return "weight", value.T
    if isinstance(owner, nn.BatchNorm2d):
        return _BN_LEAVES[leaf], value
    if leaf == "bias":
        return "bias", value
    raise KeyError(f"no torch counterpart for leaf {leaf!r} of {type(owner).__name__}")


def flax_to_torch(variables: dict[str, Any], model: nn.Module, *, strict: bool = True) -> dict[str, torch.Tensor]:
    """Convert a Flax variable tree (``params`` and ``batch_stats`` of
    numpy) into a float32 ``state_dict`` for ``model``.  ``strict`` raises
    on any Flax leaf without a torch counterpart and on any torch key the
    tree does not provide."""
    modules = dict(model.named_modules())
    state: dict[str, torch.Tensor] = {}
    unused: list[str] = []
    for path, value in _flatten({k: variables[k] for k in ("params", "batch_stats") if k in variables}).items():
        owner_name = ".".join(path[1:-1])
        owner = modules.get(owner_name)
        try:
            if owner is None:
                raise KeyError(owner_name)
            name, arr = _convert(owner, path[-1], value)
        except KeyError:
            unused.append("/".join(path))
            continue
        key = f"{owner_name}.{name}"
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros_like(buf)
    expected = set(model.state_dict())
    missing = sorted(expected - set(state))
    extra = sorted(set(state) - expected)
    if strict and (unused or missing or extra):
        raise KeyError(f"flax_to_torch: unused {unused + extra}, missing {missing}")
    for key, buf in model.state_dict().items():
        if key in state and tuple(state[key].shape) != tuple(buf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(state[key].shape)} != model {tuple(buf.shape)}")
    return state


_BN_FLAX = {v: k for k, v in _BN_LEAVES.items()}


@dataclass(frozen=True)
class Slot:
    """One torch parameter or buffer and its place in the Flax tree."""

    collection: str  # "params" or "batch_stats"
    path: tuple[str, ...]  # Flax path inside the collection
    key: str  # torch state_dict key
    kind: str  # "conv", "conv_t", "linear" or "plain": its layout change

    def to_flax(self, value: np.ndarray) -> np.ndarray:
        if self.kind == "conv":
            return np.transpose(value, (2, 3, 1, 0))
        if self.kind == "conv_t":
            return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
        if self.kind == "linear":
            return value.T
        return value

    def to_torch(self, value: np.ndarray) -> np.ndarray:
        if self.kind == "conv":
            return np.transpose(value, (3, 2, 0, 1))
        if self.kind == "conv_t":
            return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        if self.kind == "linear":
            return value.T
        return value


def _slot(modules: dict[str, nn.Module], key: str) -> Slot | None:
    owner_name, _, leaf = key.rpartition(".")
    owner = modules[owner_name]
    prefix = tuple(owner_name.split(".")) if owner_name else ()
    if isinstance(owner, nn.BatchNorm2d):
        if leaf == "num_batches_tracked":
            return None
        coll = "params" if leaf in ("weight", "bias") else "batch_stats"
        return Slot(coll, (*prefix, _BN_FLAX[leaf]), key, "plain")
    if leaf == "bias":
        return Slot("params", (*prefix, "bias"), key, "plain")
    if leaf != "weight":
        raise KeyError(f"no Flax counterpart for {key}")
    kind = (
        "conv_t" if isinstance(owner, nn.ConvTranspose2d)
        else "conv" if isinstance(owner, nn.Conv2d)
        else "linear" if isinstance(owner, nn.Linear)
        else None
    )
    if kind is None:
        raise KeyError(f"no Flax counterpart for {key} of {type(owner).__name__}")
    return Slot("params", (*prefix, "kernel"), key, kind)


def state_slots(model: nn.Module) -> list[Slot]:
    """Every entry of ``model.state_dict()`` with a Flax counterpart, sorted
    by (collection, path): the order of ``jax.tree.leaves`` per collection."""
    modules = dict(model.named_modules())
    slots = [s for s in (_slot(modules, k) for k in model.state_dict()) if s is not None]
    return sorted(slots, key=lambda s: (s.collection, s.path))


def param_slots(model: nn.Module) -> list[Slot]:
    """The trainable parameters in Flax ``params`` leaf order."""
    return [s for s in state_slots(model) if s.collection == "params"]


def torch_to_flax(model: nn.Module) -> dict[str, Any]:
    """``model``'s parameters and running statistics as a Flax variable
    tree of float32 numpy (``params`` and ``batch_stats``): the inverse of
    ``flax_to_torch``."""
    state = model.state_dict()
    tree: dict[str, Any] = {}
    for s in state_slots(model):
        node = tree.setdefault(s.collection, {})
        for p in s.path[:-1]:
            node = node.setdefault(p, {})
        value = state[s.key].detach().float().cpu().numpy()
        node[s.path[-1]] = np.ascontiguousarray(s.to_flax(value))
    return tree
