"""ResNet18 on one-channel squares as the port runs it (model id
``resnet18``): a 7×7 stride-2 stem, a max pool, four stages of two basic
blocks with 1×1 projections where the shape changes, a mean pool and a
linear head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import Layers, bn_leaves


def forward(L: Layers, x: torch.Tensor) -> torch.Tensor:
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


def leaves(width: int = 64, in_channels: int = 1, classes: int = 13) -> dict[str, tuple[int, ...]]:
    """Every leaf of ``forward`` at ``width`` with its shape (Flax layout)."""
    out = {"params/conv1/kernel": (7, 7, in_channels, width), **bn_leaves("bn1", width)}
    cin = width
    for i in range(4):
        ch = width * 2**i
        for j in range(2):
            p = f"layer{i + 1}_{j}"
            s = 2 if (i > 0 and j == 0) else 1
            out[f"params/{p}/conv1/kernel"] = (3, 3, cin, ch)
            out[f"params/{p}/conv2/kernel"] = (3, 3, ch, ch)
            out.update(bn_leaves(f"{p}/bn1", ch))
            out.update(bn_leaves(f"{p}/bn2", ch))
            if cin != ch or s != 1:
                out[f"params/{p}/down_conv/kernel"] = (1, 1, cin, ch)
                out.update(bn_leaves(f"{p}/down_bn", ch))
            cin = ch
    out["params/fc/kernel"] = (8 * width, classes)
    out["params/fc/bias"] = (classes,)
    return out


def bn_out_item(path: str, act: int) -> tuple[int, int]:
    """(output bytes an element, residual bytes an element) of the
    BatchNorm at ``path``: the stem, each block's output and its projected
    residual in float32, each block's inner map in the compute dtype."""
    if path == "bn1" or path.endswith("down_bn"):
        return 4, 0
    return (act, 0) if path.endswith("bn1") else (4, 4)
