"""The YOLO model slots, the PyTorch counterpart of
``chessvision_tpu/models/yolo.py``: compact CSP/SiLU-style convnets with
the input/output contracts of the UNet and ResNet slots, registered under
the model id ``"yolo"``.  Every ``ConvBlock`` is a bias-free convolution in
the compute dtype, a float32 BatchNorm (eps 1e-3) and SiLU.  Submodule
names follow the Flax names so that ``weights.flax_to_torch`` maps the
checkpoints one to one.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chessvision_tpu_torch.models.layers import BatchNorm2d, Conv2d


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, strides: int = 1, kernel: int = 3) -> None:
        super().__init__()
        self.conv = Conv2d(in_channels, channels, kernel, stride=strides, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two ConvBlocks; the residual is added only when the channels match."""

    def __init__(self, in_channels: int, channels: int) -> None:
        super().__init__()
        self.cv1 = ConvBlock(in_channels, channels)
        self.cv2 = ConvBlock(channels, channels)
        self.residual = in_channels == channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.residual else y


class YoloCls(nn.Module):
    """yolov8n-cls-shaped classifier: stem, 4 stride-2 stages, spatial mean
    and a float32 head.  (B, 64, 64, C) in [0, 1] in, (B, num_classes)
    float32 logits out (and the (B, 8·width) features with
    ``return_features``)."""

    def __init__(self, num_classes: int = 13, width: int = 32, in_channels: int = 1) -> None:
        super().__init__()
        w = width
        self.stem = ConvBlock(in_channels, w, strides=2)
        cin = w
        for i, ch in enumerate([w * 2, w * 4, w * 8, w * 8]):
            self.add_module(f"down{i}", ConvBlock(cin, ch, strides=2))
            self.add_module(f"block{i}", Bottleneck(ch, ch))
            cin = ch
        self.head = nn.Linear(cin, num_classes)

    def forward(
        self, x: torch.Tensor, return_features: bool = False
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x.permute(0, 3, 1, 2))
        for i in range(4):
            x = getattr(self, f"block{i}")(getattr(self, f"down{i}")(x))
        features = x.float().mean(dim=(2, 3))
        logits = self.head(features)
        return (logits, features) if return_features else logits


def _up2(t: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsample (each pixel repeated along both axes)."""
    return F.interpolate(t, scale_factor=2, mode="nearest")


class YoloSeg(nn.Module):
    """yolo11s-seg-shaped binary segmenter: 4 stride-2 encoder stages, a
    decoder of nearest upsamples with skip concatenation, and a 1×1 head
    with bias.  (B, 256, 256, 3) in [0, 1] in, (B, 256, 256, n_classes)
    float32 logits out: the UNet slot's contract."""

    def __init__(self, n_classes: int = 1, width: int = 32, n_channels: int = 3) -> None:
        super().__init__()
        w = width
        self.e1 = ConvBlock(n_channels, w, strides=2)  # /2
        self.e2 = ConvBlock(w, w * 2, strides=2)  # /4
        self.b2 = Bottleneck(w * 2, w * 2)
        self.e3 = ConvBlock(w * 2, w * 4, strides=2)  # /8
        self.b3 = Bottleneck(w * 4, w * 4)
        self.e4 = ConvBlock(w * 4, w * 8, strides=2)  # /16
        self.b4 = Bottleneck(w * 8, w * 8)
        self.d3 = ConvBlock(w * 8 + w * 4, w * 4)
        self.d2 = ConvBlock(w * 4 + w * 2, w * 2)
        self.d1 = ConvBlock(w * 2 + w, w)
        self.d0 = ConvBlock(w, w)
        self.head = Conv2d(w, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.e1(x.permute(0, 3, 1, 2))
        e2 = self.b2(self.e2(e1))
        e3 = self.b3(self.e3(e2))
        e4 = self.b4(self.e4(e3))
        d3 = self.d3(torch.cat([_up2(e4), e3], dim=1))
        d2 = self.d2(torch.cat([_up2(d3), e2], dim=1))
        d1 = self.d1(torch.cat([_up2(d2), e1], dim=1))
        d0 = self.d0(_up2(d1))
        return self.head(d0).float().permute(0, 2, 3, 1)
