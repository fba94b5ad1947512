"""chessvision-tpu on PyTorch and CUDA for an NVIDIA H100.

The port of ``chessvision_tpu`` (JAX on a TPU), which stays the reference:
the image→FEN engine and facade, the input codecs and streaming, serving,
evaluation, both trainers (one process per GPU over ``torch.distributed``
with ``parallel/``), ingestion, curation and the data tools.  It imports
torch, numpy, the standard library and cv2/pyarrow where the JAX module
does, never JAX or the JAX package.  Entry points run on the GPU unless
the caller passes ``device="cpu"``; the one TPU kernel (the hat resample
under the two-pass warp) is a hand-written CUDA kernel,
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
    ValidationMetrics,
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
    "ValidationMetrics",
]
