"""K1: the per-row linear (hat) resample under both passes of the warp.

``out[n, u] = Σ_j max(0, 1 − |pos[n, u] − j|) · src[n, j]`` with a zero
border.  Replaces the TPU kernel ``chessvision_tpu/ops/pallas_kernels.py:
banded_resample``; the JAX package's ``warp._hat_resample_last_axis`` is
the same function and the oracle.

- ``hat_resample``: the wrapper.  A CUDA tensor goes to the hand-written
  kernel ``csrc/hat_resample.cu`` (a two-tap gather, one thread per
  output; bound by device-memory bytes) or the call raises.  Only CPU
  tensors take the plain version.
- ``hat_resample_plain``: the plain PyTorch version, the broadcast
  multiply-reduce of the JAX oracle.  It serves the CPU path and the
  comparison with the kernel on the card.
- ``launches``: kernel launches so far, to show that a run went through
  the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from chessvision_tpu_torch import cuda_build

launches = 0

# rows per block of the plain version: its (rows, J, U) weight buffer is
# bounded to ~2^26 floats (256 MB) instead of growing with the batch
_PLAIN_ELEMS = 1 << 26


def hat_resample_plain(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(..., J) rows resampled at (..., U) positions, by the full-width
    broadcast multiply-reduce.  At most two terms of each sum are nonzero,
    so any summation order gives the same float."""
    j = src.shape[-1]
    lead = src.shape[:-1]
    src2 = src.reshape(-1, j).float()
    pos2 = pos.reshape(-1, pos.shape[-1]).float()
    jj = torch.arange(j, dtype=torch.float32, device=src.device)
    rows = max(1, _PLAIN_ELEMS // (j * pos2.shape[-1]))
    out = torch.empty_like(pos2)
    for r0 in range(0, src2.shape[0], rows):
        p = pos2[r0 : r0 + rows]
        w = torch.clamp_min(1.0 - torch.abs(p[:, None, :] - jj[:, None]), 0.0)  # (r, J, U)
        out[r0 : r0 + rows] = torch.sum(w * src2[r0 : r0 + rows, :, None], dim=-2)
    return out.reshape(*lead, pos.shape[-1])


def _launch(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    global launches
    if src.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"hat_resample kernel takes float32, got {src.dtype}, {pos.dtype}")
    if src.device != pos.device:
        raise ValueError(f"src on {src.device}, pos on {pos.device}")
    if src.shape[:-1] != pos.shape[:-1]:
        raise ValueError(f"leading shapes differ: {tuple(src.shape)} vs {tuple(pos.shape)}")
    j, u = src.shape[-1], pos.shape[-1]
    src2 = src.reshape(-1, j).contiguous()
    pos2 = pos.reshape(-1, u).contiguous()
    n = src2.shape[0]
    if n * max(j, u) >= 2**31 or n * u // 256 >= 2**31:
        raise ValueError(f"hat_resample kernel: shape {(n, j, u)} too large")
    out = torch.empty((n, u), dtype=torch.float32, device=src.device)
    lib = cuda_build.load("hat_resample")
    fn = lib.hat_resample_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src2.data_ptr(), pos2.data_ptr(), out.data_ptr(), n, j, u, stream)
    if err != 0:
        raise RuntimeError(f"hat_resample kernel launch failed: cudaError {err}")
    launches += 1
    return out.reshape(*src.shape[:-1], u)


def hat_resample(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K1 dispatch: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    if src.is_cuda or pos.is_cuda:
        return _launch(src, pos)
    if src.device.type == "cpu" and pos.device.type == "cpu":
        return hat_resample_plain(src, pos)
    raise ValueError(f"hat_resample: unsupported device {src.device}")
