"""milesial's UNet as the port runs it (model id ``unet``): four max-pool
downs, four transposed-convolution ups, BatchNorm and ReLU after every
3×3 convolution."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import Layers, bn_leaves


def _double_conv(L: Layers, x: torch.Tensor, path: str) -> torch.Tensor:
    x = F.relu(L.bn(L.conv(x, f"{path}/conv1", padding=1), f"{path}/bn1", 1e-5))
    return F.relu(L.bn(L.conv(x, f"{path}/conv2", padding=1), f"{path}/bn2", 1e-5))


def forward(L: Layers, x: torch.Tensor) -> torch.Tensor:
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
        out.update(bn_leaves(f"{path}/{bn}", cout))
    return out


def leaves(base: int = 64, bilinear: bool = False) -> dict[str, tuple[int, ...]]:
    """Every leaf of ``forward`` at ``base`` with its shape (Flax layout)."""
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


def bn_out_item(path: str, act: int) -> tuple[int, int]:
    """(output bytes an element, residual bytes an element) of the
    BatchNorm at ``path``: every map in the compute dtype but the
    bottleneck's (``down4``), in float32; no residual."""
    return (4 if path.startswith("down4/") and path.endswith("bn2") else act), 0
