"""K1: the linear (hat) resample under both passes of the two-pass warp.

``out[n, u] = Σ_j max(0, 1 − |pos[n, u] − j|) · src[n, j]`` with a zero
border.  Replaces the TPU kernel ``chessvision_tpu/ops/pallas_kernels.py:
banded_resample``; the JAX package's ``warp._hat_resample_last_axis`` is
the same function and the oracle.  The kernels are hand-written CUDA,
``csrc/hat_resample.cu``; both entries are bound by device-memory bytes.

- ``warp_twopass``: what the main path calls, the whole two-pass warp from
  the images and the inverse homographies.  On CUDA tensors it is two
  kernel launches (``warp_pass1``, ``warp_pass2``) or the call raises.
  Each thread computes its own sample positions in registers, rounding
  every operation as the plain version's eager ops do, so no position
  tensor is built or read; pass 1 stages source rows in shared memory
  (``pass1_plan``: 8, 4, 2 or 1 rows a block by the width, and rows too
  wide for any of it read from device memory, so every width runs);
  pass 2 reads the intermediate's columns in place and writes the result
  in its final layout.  What moves through device memory is the images,
  the intermediate (written and read once) and the result.
- ``hat_resample``: the TPU kernel's own signature, positions given.  Not
  on the main path.  On CUDA tensors the kernel reads ``src`` in place
  through its batch, row and element strides (a transposed view needs no
  copy) or the call raises.
- ``warp_twopass_plain``, ``twopass_positions``, ``hat_resample_plain``:
  the plain PyTorch versions (positions as tensors; the broadcast
  multiply-reduce of the JAX oracle).  Only CPU tensors take them in the
  wrappers; on the card they are what the kernels are compared with.
- ``launches``: kernel launches so far (either entry), to show that a run
  went through the kernels.  A call whose result has no element reaches
  the launcher, which launches nothing and says so; it does not count.
"""

from __future__ import annotations

import ctypes

import torch

from chessvision_tpu_torch import cuda_build

launches = 0

# rows per block of the plain version: its (rows, J, U) weight buffer is
# bounded to ~2^26 floats (256 MB) instead of growing with the batch
_PLAIN_ELEMS = 1 << 26

# limits of csrc/hat_resample.cu: the most source rows a pass-1 block
# owns, the most shared memory a block can have, and gridDim.z
_P1_ROWS = 8
_SHARED_BYTES = 232448
_GRID_Z = 65535
# a launcher's return when the shape holds no output element
_NOTHING_LAUNCHED = -1


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


def _guard(den: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(den) < 1e-8, torch.full_like(den, 1e-8), den)


def twopass_positions(minv: torch.Tensor, src_h: int, out_h: int, out_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-pass warp's sample positions from (B, 3, 3) inverse
    homographies: ``hx`` (B, src_h, out_w), where pass 1 samples source row
    y for output column u, hx(u, y) = X(u, v*) with Y(u, v*) = y; and
    ``vy`` (B, out_w, out_h), where pass 2 samples column u of the
    intermediate for output row v, Y(u, v)."""
    dev = minv.device

    def bc(t: torch.Tensor) -> torch.Tensor:  # (B,) → (B, 1, 1)
        return t[:, None, None]

    a_, b_, c_ = bc(minv[:, 0, 0]), bc(minv[:, 0, 1]), bc(minv[:, 0, 2])
    d_, e_, f_ = bc(minv[:, 1, 0]), bc(minv[:, 1, 1]), bc(minv[:, 1, 2])
    g_, h_, i_ = bc(minv[:, 2, 0]), bc(minv[:, 2, 1]), bc(minv[:, 2, 2])

    # pass-1 positions hx over (B, y=src_h, u=out_w)
    ys = torch.arange(src_h, dtype=torch.float32, device=dev)[:, None].expand(src_h, out_w)
    us = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(src_h, out_w)
    den_v = e_ - ys * h_
    v_star = (ys * (g_ * us + i_) - d_ * us - f_) / _guard(den_v)
    den_x = g_ * us + h_ * v_star + i_
    hx = (a_ * us + b_ * v_star + c_) / _guard(den_x)

    # pass-2 positions Y over (B, u=out_w, v=out_h)
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :].expand(out_w, out_h)
    uu = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None].expand(out_w, out_h)
    den = g_ * uu + h_ * vs + i_
    vy = (d_ * uu + e_ * vs + f_) / _guard(den)
    return hx, vy


def warp_twopass_plain(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The plain two-pass warp: the positions as tensors, the plain
    resample along source rows, then along the intermediate's columns."""
    hx, vy = twopass_positions(minv, imgs.shape[1], out_h, out_w)
    tmp = hat_resample_plain(imgs, hx)  # (B, src_h, out_w)
    out_t = hat_resample_plain(tmp.transpose(1, 2), vy)  # (B, out_w, out_h)
    return out_t.transpose(1, 2)


def _kernel(name: str, argtypes: list):
    fn = getattr(cuda_build.load("hat_resample"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _run(fn, name: str, device: torch.device, *args) -> None:
    """Launch on the current stream of ``device``; raise unless the launch
    was accepted; count it if the launcher launched."""
    global launches
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == _NOTHING_LAUNCHED:
        return
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches += 1


def _launch(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if src.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"hat_resample kernel takes float32, got {src.dtype}, {pos.dtype}")
    if src.device != pos.device:
        raise ValueError(f"src on {src.device}, pos on {pos.device}")
    if src.shape[:-1] != pos.shape[:-1]:
        raise ValueError(f"leading shapes differ: {tuple(src.shape)} vs {tuple(pos.shape)}")
    j, u = src.shape[-1], pos.shape[-1]
    # (batches, rows, J) through its own strides: a transposed view is read
    # in place (leading axes beyond the batch fold into it)
    src3 = src.reshape(1, -1, j) if src.ndim < 3 else src.flatten(0, -3)
    pos2 = pos.reshape(-1, u).contiguous()
    batches, rows = src3.shape[0], src3.shape[1]
    n = batches * rows
    if n * max(j, u) >= 2**31:
        raise ValueError(f"hat_resample kernel: shape {(n, j, u)} over the int32 index limit")
    out = torch.empty((n, u), dtype=torch.float32, device=src.device)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn = _kernel("hat_resample_launch", [ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, ptr])
    _run(fn, "hat_resample", src.device, src3.data_ptr(), pos2.data_ptr(), out.data_ptr(),
         batches, rows, j, u, *src3.stride())
    return out.reshape(*src.shape[:-1], u)


def hat_resample(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K1 with the positions given: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; any other device raises."""
    if src.is_cuda or pos.is_cuda:
        return _launch(src, pos)
    if src.device.type == "cpu" and pos.device.type == "cpu":
        return hat_resample_plain(src, pos)
    raise ValueError(f"hat_resample: unsupported device {src.device}")


def _check_warp(imgs: torch.Tensor, minv: torch.Tensor) -> None:
    if imgs.dtype != torch.float32 or minv.dtype != torch.float32:
        raise TypeError(f"warp_twopass takes float32, got {imgs.dtype}, {minv.dtype}")
    if imgs.ndim != 3 or minv.shape != (imgs.shape[0], 3, 3):
        raise ValueError(f"warp_twopass takes (B, H, W) and (B, 3, 3), got {tuple(imgs.shape)}, {tuple(minv.shape)}")
    if imgs.device != minv.device:
        raise ValueError(f"imgs on {imgs.device}, minv on {minv.device}")


def pass1_plan(w: int) -> tuple[int, int]:
    """Pass 1's launch plan for source rows of ``w`` floats: (rows a block
    owns, shared-memory bytes it stages them in).  The most rows of 8, 4,
    2 and 1 whose floats fit a block's shared memory; a row wider than all
    of it (w > 58 112) takes the kernel that reads its taps from device
    memory, (8, 0)."""
    for rows in (_P1_ROWS, 4, 2, 1):
        if rows * w * 4 <= _SHARED_BYTES:
            return rows, rows * w * 4
    return _P1_ROWS, 0


def warp_pass1(imgs: torch.Tensor, minv: torch.Tensor, out_w: int) -> torch.Tensor:
    """Pass 1 on the card: (B, H, W) source rows resampled at hx →
    (B, H, out_w).  One kernel launch, for any width."""
    _check_warp(imgs, minv)
    if not (imgs.is_cuda and imgs.is_contiguous() and minv.is_contiguous()):
        raise ValueError("warp_twopass kernel takes contiguous CUDA tensors")
    b, h, w = imgs.shape
    rows, smem = pass1_plan(w)
    if h * max(w, out_w) >= 2**31 or b * -(-h // rows) >= 2**31:
        raise ValueError(f"warp_twopass kernel: shape {(b, h, w, out_w)} over the int32 index limit")
    tmp = torch.empty((b, h, out_w), dtype=torch.float32, device=imgs.device)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = _kernel("warp_pass1_launch", [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr])
    _run(fn, "warp_pass1", imgs.device, imgs.data_ptr(), minv.data_ptr(), tmp.data_ptr(),
         b, h, w, out_w, rows, smem)
    return tmp


def warp_pass2(tmp: torch.Tensor, minv: torch.Tensor, out_h: int) -> torch.Tensor:
    """Pass 2 on the card: the columns of (B, H, out_w) resampled at vy →
    (B, out_h, out_w), read and written in place of any transpose.  One
    kernel launch."""
    _check_warp(tmp, minv)
    if not (tmp.is_cuda and tmp.is_contiguous() and minv.is_contiguous()):
        raise ValueError("warp_twopass kernel takes contiguous CUDA tensors")
    b, h, out_w = tmp.shape
    if max(h, out_h) * out_w >= 2**31 or b > _GRID_Z:
        raise ValueError(f"warp_twopass kernel: shape {(b, h, out_h, out_w)} over the kernel's index limits")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=tmp.device)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = _kernel("warp_pass2_launch", [ptr, ptr, ptr, i32, i32, i32, i32, ptr])
    _run(fn, "warp_pass2", tmp.device, tmp.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, out_h, out_w)
    return out


def warp_twopass(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """K1 as the main path calls it: (B, H, W) float32 images warped by
    (B, 3, 3) inverse homographies to (B, out_h, out_w).  CUDA tensors go
    through the two kernels (contiguous result) or the call raises; CPU
    tensors take the plain version; any other device raises."""
    _check_warp(imgs, minv)
    if imgs.is_cuda:
        return warp_pass2(warp_pass1(imgs, minv, out_w), minv, out_h)
    if imgs.device.type == "cpu":
        return warp_twopass_plain(imgs, minv, out_h, out_w)
    raise ValueError(f"warp_twopass: unsupported device {imgs.device}")
