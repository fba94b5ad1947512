"""Grayscale conversion, flips and mask thresholding on tensors.

Counterpart of ``chessvision_tpu/ops/color.py``.  The exact path is
cv2's fixed-point BGR→gray in int32, bit for bit.
"""

from __future__ import annotations

import torch

# Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
_R_COEF = 9798
_G_COEF = 19235
_B_COEF = 3735
_SHIFT = 15


def bgr_to_gray(img: torch.Tensor, *, exact_u8: bool = False) -> torch.Tensor:
    """(..., H, W, 3) BGR → (..., H, W) gray.  ``exact_u8`` takes uint8 and
    returns uint8 equal to cv2.cvtColor; otherwise float32."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    if exact_u8:
        acc = (
            r.to(torch.int32) * _R_COEF
            + g.to(torch.int32) * _G_COEF
            + b.to(torch.int32) * _B_COEF
            + (1 << (_SHIFT - 1))
        )
        return (acc >> _SHIFT).to(torch.uint8)
    scale = float(1 << _SHIFT)
    return (
        r.float() * (_R_COEF / scale)
        + g.float() * (_G_COEF / scale)
        + b.float() * (_B_COEF / scale)
    )


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of (..., H, W) or (..., H, W, C) with C ≤ 4."""
    axis = img.ndim - 1
    if img.shape[-1] <= 4 and img.ndim >= 3:
        axis = img.ndim - 2
    return torch.flip(img, dims=(axis,))


def create_binary_mask(probabilities: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Probability mask → uint8 {0, 255}; strictly greater than threshold."""
    return torch.where(probabilities > threshold, 255, 0).to(torch.uint8)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """float → uint8 by floor(x + 0.5) and clipping (half rounds up, as
    cv2's saturate_cast does here; ``torch.round`` rounds half to even)."""
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)
