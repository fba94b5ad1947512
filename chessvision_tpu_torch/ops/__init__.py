"""Image ops of the PyTorch port, counterparts of ``chessvision_tpu/ops``."""

from chessvision_tpu_torch.ops.color import bgr_to_gray, create_binary_mask, hflip
from chessvision_tpu_torch.ops.resize import resize, resize_matrices
from chessvision_tpu_torch.ops.squares import extract_squares_batch
from chessvision_tpu_torch.ops.warp import (
    get_perspective_transform,
    invert_homography,
    warp_perspective,
)

__all__ = [
    "bgr_to_gray",
    "create_binary_mask",
    "hflip",
    "resize",
    "resize_matrices",
    "extract_squares_batch",
    "get_perspective_transform",
    "invert_homography",
    "warp_perspective",
]
