"""UNet for board segmentation, the PyTorch counterpart of
``chessvision_tpu/models/unet.py`` (``bilinear=False``): DoubleConv stem,
4 Down stages, 4 Up stages with 2×2 stride-2 transposed convolutions and
skip-first concatenation, and a 1×1 head with bias.  Submodule names
follow the Flax module names so that ``weights.flax_to_torch`` maps the
checkpoint one to one.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chessvision_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None) -> None:
        super().__init__()
        mid = mid_channels or out_channels
        self.conv1 = Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2))


class Up(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int, out_channels: int) -> None:
        super().__init__()
        self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
        self.conv = DoubleConv(in_channels // 2 + skip_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        # concatenation promotes to the wider type, as jnp.concatenate does
        dtype = torch.promote_types(x1.dtype, x2.dtype)
        return self.conv(torch.cat([x2.to(dtype), x1.to(dtype)], dim=1))


class UNet(nn.Module):
    """UNet(n_channels → n_classes) over NHWC inputs in [0, 1]; returns
    float32 NHWC logits, and with ``return_features`` also the pooled
    bottleneck (B, 16·base), the collectors' embedding."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, base: int = 64, bilinear: bool = False) -> None:
        super().__init__()
        if bilinear:
            raise NotImplementedError("the port has the bilinear=False UNet only")
        b = base
        self.inc = DoubleConv(n_channels, b)
        self.down1 = Down(b, b * 2)
        self.down2 = Down(b * 2, b * 4)
        self.down3 = Down(b * 4, b * 8)
        self.down4 = Down(b * 8, b * 16)
        self.up1 = Up(b * 16, b * 8, b * 8)
        self.up2 = Up(b * 8, b * 4, b * 4)
        self.up3 = Up(b * 4, b * 2, b * 2)
        self.up4 = Up(b * 2, b, b)
        self.outc = Conv2d(b, n_classes, 1)

    def forward(
        self, x: torch.Tensor, return_features: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        logits = self.outc(x).float().permute(0, 2, 3, 1)
        if return_features:
            return logits, x5.float().mean(dim=(2, 3))
        return logits
