"""ResNet18 piece classifier, the PyTorch counterpart of
``chessvision_tpu/models/resnet.py``: 7×7/2 stem (pad 3), 3×3/2 max pool
(pad 1), BasicBlock stages with a 1×1/2 ``down_conv`` where the shape
changes, spatial mean (the features that ``return_features`` also returns), then
``fc`` in float32.  Submodule names follow
the Flax names.  NHWC (N, 64, 64, 1) in, (N, 13) float32 logits out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chessvision_tpu_torch.models.layers import BatchNorm2d, Conv2d, conv_dtype


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, strides: int = 1) -> None:
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride=strides, padding=1, bias=False)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(channels)
        self.has_down = in_channels != channels or strides != 1
        if self.has_down:
            self.down_conv = Conv2d(in_channels, channels, 1, stride=strides, bias=False)
            self.down_bn = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in inference bn1's map is stored in conv2's dtype (its only
        # reader) and the block's output, the next block's residual, in
        # float32 by one pass of bn2 + residual + ReLU
        y = self.conv2(self.bn1.act(self.conv1(x), out_dtype=conv_dtype(self.conv2)))
        residual = self.down_bn.act(self.down_conv(x), "none") if self.has_down else x
        return self.bn2.act(y, residual=residual)


class ResNet(nn.Module):
    """ResNet-18/34-style classifier (BasicBlock stages)."""

    def __init__(
        self,
        num_classes: int = 13,
        in_channels: int = 1,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        width: int = 64,
    ) -> None:
        super().__init__()
        self.conv1 = Conv2d(in_channels, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.block_names: list[str] = []
        cin = width
        for i, blocks in enumerate(stage_sizes):
            channels = width * 2**i
            for j in range(blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, BasicBlock(cin, channels, 2 if (i > 0 and j == 0) else 1))
                self.block_names.append(name)
                cin = channels
        self.fc = nn.Linear(cin, num_classes)

    def forward(
        self, x: torch.Tensor, return_features: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        # float32: the max-pooled stem is layer1_0's residual
        x = self.bn1.act(self.conv1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        features = x.float().mean(dim=(2, 3))
        logits = self.fc(features)
        return (logits, features) if return_features else logits


def resnet18(num_classes: int = 13, in_channels: int = 1, width: int = 64) -> ResNet:
    return ResNet(num_classes=num_classes, in_channels=in_channels, stage_sizes=(2, 2, 2, 2), width=width)
