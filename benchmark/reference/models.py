"""Plain float32 forwards of the models, read straight from the repo's
``.npz`` checkpoints or from seeded leaves (the Flax variable tree,
flattened to ``params/...`` and ``batch_stats/...`` keys; ``LEAVES``
gives each architecture's leaves and their shapes).

Every convolution and linear layer goes through ``Layers.conv`` /
``Layers.linear``; BatchNorm uses the running statistics in Flax's order,
``(x − mean) · rsqrt(var + eps) · scale + bias``.  ``Layers(precision=
"fp8")`` is the benchmark's lower-precision control: the input and the
weight of every convolution and linear layer are rounded to float8 e4m3
with one scale a tensor (its largest magnitude to 448), products summed in
float32.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_F8_MAX = 448.0


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

    def conv(self, x: torch.Tensor, path: str, stride: int = 1, padding: int = 0) -> torch.Tensor:
        w = self.t[f"params/{path}/kernel"].permute(3, 2, 0, 1)  # HWIO → OIHW
        b = self.t.get(f"params/{path}/bias")
        return F.conv2d(self._q(x.float()), self._q(w), b, stride, padding)

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


# -- UNet ----------------------------------------------------------------------


def _double_conv(L: Layers, x: torch.Tensor, path: str) -> torch.Tensor:
    x = F.relu(L.bn(L.conv(x, f"{path}/conv1", padding=1), f"{path}/bn1", 1e-5))
    return F.relu(L.bn(L.conv(x, f"{path}/conv2", padding=1), f"{path}/bn2", 1e-5))


def unet(L: Layers, x: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) in [0, 1] → (B, 256, 256) logits; transposed-conv
    upsampling (the shipped checkpoint's ``bilinear: false``)."""
    x = x.permute(0, 3, 1, 2)
    skips = [_double_conv(L, x, "inc")]
    for i in (1, 2, 3):
        skips.append(_double_conv(L, F.max_pool2d(skips[-1], 2), f"down{i}/conv"))
    x = _double_conv(L, F.max_pool2d(skips[-1], 2), "down4/conv")
    for i in (1, 2, 3, 4):
        up = L.conv_transpose2x2(x, f"up{i}/up")
        skip = skips.pop()
        dh, dw = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
        if dh or dw:
            up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        x = _double_conv(L, torch.cat([skip, up], dim=1), f"up{i}/conv")
    return L.conv(x, "outc")[:, 0]


def _double_conv_leaves(path: str, cin: int, cout: int) -> dict[str, tuple[int, ...]]:
    out = {f"params/{path}/conv1/kernel": (3, 3, cin, cout), f"params/{path}/conv2/kernel": (3, 3, cout, cout)}
    for bn in ("bn1", "bn2"):
        out.update(_bn_leaves(f"{path}/{bn}", cout))
    return out


def _bn_leaves(path: str, ch: int) -> dict[str, tuple[int, ...]]:
    return {f"params/{path}/scale": (ch,), f"params/{path}/bias": (ch,),
            f"batch_stats/{path}/mean": (ch,), f"batch_stats/{path}/var": (ch,)}


def unet_leaves(base: int = 64, bilinear: bool = False) -> dict[str, tuple[int, ...]]:
    """Every leaf of ``unet`` at ``base`` with its shape (Flax layout)."""
    if bilinear:
        raise ValueError("the reference's UNet upsamples by transposed convolutions only")
    out = _double_conv_leaves("inc", 3, base)
    for i in (1, 2, 3, 4):
        out.update(_double_conv_leaves(f"down{i}/conv", base * 2 ** (i - 1), base * 2**i))
    for i in (1, 2, 3, 4):
        cin = base * 2 ** (5 - i)
        out[f"params/up{i}/up/kernel"] = (2, 2, cin, cin // 2)
        out[f"params/up{i}/up/bias"] = (cin // 2,)
        out.update(_double_conv_leaves(f"up{i}/conv", cin, cin // 2))
    out["params/outc/kernel"] = (1, 1, base, 1)
    out["params/outc/bias"] = (1,)
    return out


# -- ResNet18 -------------------------------------------------------------------


def resnet18(L: Layers, x: torch.Tensor) -> torch.Tensor:
    """(N, 64, 64, 1) in [0, 1] → (N, 13) logits."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(L.bn(L.conv(x, "conv1", stride=2, padding=3), "bn1", 1e-5))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    cin = x.shape[1]
    width = cin
    for i in range(4):
        ch = width * 2**i
        for j in range(2):
            p = f"layer{i + 1}_{j}"
            s = 2 if (i > 0 and j == 0) else 1
            y = F.relu(L.bn(L.conv(x, f"{p}/conv1", stride=s, padding=1), f"{p}/bn1", 1e-5))
            y = L.bn(L.conv(y, f"{p}/conv2", padding=1), f"{p}/bn2", 1e-5)
            res = L.bn(L.conv(x, f"{p}/down_conv", stride=s), f"{p}/down_bn", 1e-5) if (cin != ch or s != 1) else x
            x = F.relu(y + res)
            cin = ch
    return L.linear(x.mean(dim=(2, 3)), "fc")


def resnet18_leaves(width: int = 64, in_channels: int = 1, classes: int = 13) -> dict[str, tuple[int, ...]]:
    """Every leaf of ``resnet18`` at ``width`` with its shape (Flax layout)."""
    out = {"params/conv1/kernel": (7, 7, in_channels, width), **_bn_leaves("bn1", width)}
    cin = width
    for i in range(4):
        ch = width * 2**i
        for j in range(2):
            p = f"layer{i + 1}_{j}"
            s = 2 if (i > 0 and j == 0) else 1
            out[f"params/{p}/conv1/kernel"] = (3, 3, cin, ch)
            out[f"params/{p}/conv2/kernel"] = (3, 3, ch, ch)
            out.update(_bn_leaves(f"{p}/bn1", ch))
            out.update(_bn_leaves(f"{p}/bn2", ch))
            if cin != ch or s != 1:
                out[f"params/{p}/down_conv/kernel"] = (1, 1, cin, ch)
                out.update(_bn_leaves(f"{p}/down_bn", ch))
            cin = ch
    out["params/fc/kernel"] = (8 * width, classes)
    out["params/fc/bias"] = (classes,)
    return out


EXTRACTORS = {"unet": unet}
CLASSIFIERS = {"resnet18": resnet18}
LEAVES = {"unet": unet_leaves, "resnet18": resnet18_leaves}
