"""Plain float32 forwards of the models, read straight from the repo's
``.npz`` checkpoints or from seeded leaves (the Flax variable tree,
flattened to ``params/...`` and ``batch_stats/...`` keys).

Each architecture is one file, ``archs/<model_id>.py``, named by the
port's model id and found by ``arch(model_id)``.  It defines
``forward(L, x)``, the plain float32 forward (an extractor maps
(B, 256, 256, 3) in [0, 1] to (B, 256, 256) logits, a classifier
(N, 64, 64, 1) to (N, 13)); ``leaves(**arch)``, every leaf with its shape
in Flax's layout; and, where the port runs the model's BatchNorms through
``bn_act``, ``bn_out_item(path, act)``, the output and residual bytes of
one element of the BatchNorm at ``path`` (``counts/bn_bytes.py``).

An architecture file sends every convolution and linear layer through
``Layers.conv``, ``Layers.conv_transpose2x2`` or ``Layers.linear`` and
never calls ``F.conv2d`` or ``F.linear`` itself: the control below rounds
only what passes through them.  BatchNorm uses the running statistics in
Flax's order, ``(x − mean) · rsqrt(var + eps) · scale + bias``.
``Layers(precision="fp8")`` is the benchmark's lower-precision control:
the input and the weight of every convolution and linear layer are rounded
to float8 e4m3 with one scale a tensor (its largest magnitude to 448),
products summed in float32.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType

import numpy as np
import torch
import torch.nn.functional as F

_F8_MAX = 448.0
ARCHS = Path(__file__).resolve().parent / "archs"  # one file a model id


def load_npz(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """(flat float32 arrays without the optimizer state, metadata) of a
    checkpoint; an EMA view, where there is one, replaces ``params``."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files if k != "__metadata__"}
        meta = json.loads(bytes(data["__metadata__"].tolist()).decode()) if "__metadata__" in data.files else {}
    flat = {k: v for k, v in flat.items() if not k.startswith("opt_state/")}
    ema = {k[len("ema_params/"):]: v for k, v in flat.items() if k.startswith("ema_params/")}
    if ema:
        flat = {k: v for k, v in flat.items() if not k.startswith(("ema_params/", "params/"))}
        flat.update({f"params/{k}": v for k, v in ema.items()})
    return flat, meta


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / _F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Layers:
    """The checkpoint's tensors on ``device`` and the layer functions."""

    def __init__(self, flat: dict[str, np.ndarray], device: torch.device, precision: str = "fp32") -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in flat.items()}
        self.precision = precision
        self.ops: list[tuple] = []  # (kind, module path, input shape) of each call, when recording
        self.recording = False

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def conv(self, x: torch.Tensor, path: str, stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
        # (kh, kw, in / groups, out) → (out, in / groups, kh, kw)
        w = self.t[f"params/{path}/kernel"].permute(3, 2, 0, 1)
        b = self.t.get(f"params/{path}/bias")
        return F.conv2d(self._q(x.float()), self._q(w), b, stride, padding, 1, groups)

    def conv_transpose2x2(self, x: torch.Tensor, path: str) -> torch.Tensor:
        k = self.t[f"params/{path}/kernel"]  # (kH, kW, in, out), flipped against torch's
        w = torch.flip(k, dims=(0, 1)).permute(2, 3, 0, 1)
        return F.conv_transpose2d(self._q(x.float()), self._q(w), self.t[f"params/{path}/bias"], stride=2)

    def linear(self, x: torch.Tensor, path: str) -> torch.Tensor:
        w = self.t[f"params/{path}/kernel"].T
        return F.linear(self._q(x.float()), self._q(w), self.t[f"params/{path}/bias"])

    def bn(self, x: torch.Tensor, path: str, eps: float) -> torch.Tensor:
        if self.recording:
            self.ops.append(("bn", path, tuple(x.shape)))
        mean = self.t[f"batch_stats/{path}/mean"][:, None, None]
        var = self.t[f"batch_stats/{path}/var"][:, None, None]
        scale = self.t[f"params/{path}/scale"][:, None, None]
        bias = self.t[f"params/{path}/bias"][:, None, None]
        return (x.float() - mean) * (torch.rsqrt(var + eps) * scale) + bias


def bn_leaves(path: str, ch: int) -> dict[str, tuple[int, ...]]:
    """The four leaves of a BatchNorm of ``ch`` channels at ``path``."""
    return {f"params/{path}/scale": (ch,), f"params/{path}/bias": (ch,),
            f"batch_stats/{path}/mean": (ch,), f"batch_stats/{path}/var": (ch,)}


@functools.lru_cache(maxsize=None)
def _load(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"benchmark_archs_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch(model_id: str) -> ModuleType:
    """The module ``archs/<model_id>.py`` (``ARCHS``): its ``forward``,
    ``leaves`` and, where it has one, ``bn_out_item``."""
    path = ARCHS / f"{model_id}.py"
    if not path.is_file():
        have = sorted(p.stem for p in ARCHS.glob("*.py"))
        raise KeyError(f"no architecture {model_id!r} in {ARCHS}; have {have}")
    return _load(path)
