"""Device selection and float32 settings shared by the port's entry points."""

from __future__ import annotations

import contextlib
import logging
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  The default is the GPU; with no
    CUDA device a caller must ask for ``device="cpu"`` explicitly — there
    is no silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "chessvision_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions inside the block, restored
    after.  The pipeline's float32 stages (resize, homographies, grid
    detection and correction, and the models in float32) then compute in
    full float32 as the JAX package does; bfloat16 convolutions are not
    affected."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def setup_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """A logger with one stream handler and a timestamped format."""
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(handler)
    log.setLevel(level)
    return log


def default_train_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 convolutions on the GPU, as the JAX trainers use on the
    TPU; float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
