"""Layers with the Flax modules' mixed-precision contract.

In the JAX package every convolution runs in the model's ``dtype`` (its
input cast to it) while BatchNorm and the classifier head compute in
float32.  ``Conv2d``/``ConvTranspose2d`` here cast their input to the
dtype of their weight, ``BatchNorm2d`` computes in float32, and
``set_compute_dtype`` puts a model's convolutions into the compute dtype
after its float32 weights are loaded.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x.to(self.weight.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """Inference BatchNorm in float32 (running statistics; eps 1e-5 in the
    UNet and the ResNet, 1e-3 in the YOLO family)."""

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the convolutions of ``model`` to ``dtype``; BatchNorm and
    Linear layers stay float32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return model
