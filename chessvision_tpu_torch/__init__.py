"""chessvision-tpu on PyTorch and CUDA: the image→FEN main path for an
NVIDIA H100.

The port of ``chessvision_tpu`` (JAX on a TPU), which stays the reference.
It imports torch, numpy and the standard library, never JAX or the JAX
package.  Entry points run on the GPU unless the caller passes
``device="cpu"``; the one TPU kernel of the path (the hat resample under
the two-pass warp) is a hand-written CUDA kernel,
``csrc/hat_resample.cu``.
"""

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.cv_types import (
    BatchResult,
    BoardExtractionResult,
    ChessVisionResult,
    PositionResult,
    ValidationFix,
)
from chessvision_tpu_torch.engine import Engine

__all__ = [
    "ChessVision",
    "Engine",
    "constants",
    "BatchResult",
    "BoardExtractionResult",
    "ChessVisionResult",
    "PositionResult",
    "ValidationFix",
]
