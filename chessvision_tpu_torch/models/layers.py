"""Layers with the Flax modules' mixed-precision contract.

In the JAX package every convolution runs in the model's ``dtype`` (its
input and its float32 parameters cast to it) while BatchNorm and the
classifier head compute in float32.  ``Conv2d``/``ConvTranspose2d`` here
compute in their ``compute_dtype`` when one is set (float32 master weights,
cast inside ``forward``: the training contract) and otherwise in the dtype
of their weight (weights cast once: the inference contract of
``set_compute_dtype``).  ``BatchNorm2d`` computes in float32 and has the
Flax train path: batch statistics, running averages updated with the
biased batch variance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in float32 (eps 1e-5 in the UNet and the ResNet, 1e-3 in
    the YOLO family).  In eval mode it normalizes with the running
    statistics.  In train mode it normalizes with the batch's mean and
    biased variance and updates the running statistics as Flax's
    ``nn.BatchNorm(momentum=0.9)`` does: ``r = 0.9·r + 0.1·s`` with the
    biased variance (``nn.BatchNorm2d`` would use the unbiased one)."""

    flax_momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5) -> None:
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        # Flax's train path op for op: the mean and the "fast" variance
        # E[x²] − E[x]² (clipped at 0) normalize, and the gradient flows
        # through the same formula
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def set_compute_dtype(model: nn.Module, dtype: torch.dtype, *, master_weights: bool = False) -> nn.Module:
    """Put the convolutions of ``model`` into ``dtype``; BatchNorm and
    Linear layers stay float32.  By default the convolution weights are
    cast (inference); with ``master_weights`` they stay float32 and are cast
    inside each ``forward``, so gradients land on float32 parameters
    (training)."""
    for m in model.modules():
        if master_weights and isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return model
