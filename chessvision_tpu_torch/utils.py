"""Device selection, host arrays and float32 settings shared by the
port's entry points."""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Iterator

import numpy as np
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


def host_tensor(a: Any, **kwargs: Any) -> torch.Tensor:
    """``torch.as_tensor(a, **kwargs)`` that also takes numpy arrays with a
    negative stride (``img[..., ::-1]``, ``np.flip``, ``frames[::-1]``),
    which ``torch.as_tensor`` refuses: only those are copied, into a
    contiguous array.  Tensors and arrays with positive strides stay
    zero-copy where ``torch.as_tensor`` keeps them so."""
    if isinstance(a, np.ndarray) and any(s < 0 for s in a.strides):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, **kwargs)


# full_f32's open blocks over every thread, and the flags the first one found
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = (True, True)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions inside the block.  The
    pipeline's float32 stages (resize, homographies, grid detection and
    correction, and the models in float32) then compute in full float32 as
    the JAX package does; bfloat16 convolutions are not affected.

    Safe across threads and when nested: the blocks open in the process
    are counted under a lock; the first to open saves both flags and
    clears them, and the last to close restores what the first saved.  So
    inside any thread's block both flags are False, and the caller's own
    settings come back once no block is open.  The limit: torch keeps these
    flags for the whole process, so a thread outside every block also sees
    them False while another thread is inside one."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _f32_saved


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
