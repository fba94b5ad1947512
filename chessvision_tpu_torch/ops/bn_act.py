"""Inference BatchNorm + residual + ReLU in one pass, written once.

``out = relu((x − mean) · mul + bias [+ residual])`` in float32, in Flax's
order (``flax.linen.normalization._normalize``; ``mul = rsqrt(var + eps) ·
weight``), stored in ``out_dtype``.  It has no TPU kernel behind it: in the
JAX package XLA fuses BatchNorm, the residual sum, the ReLU and the cast to
the next convolution's dtype, so no float32 map is stored; eager PyTorch
stores three.  The kernel is hand-written CUDA, ``csrc/bn_act.cu``, bound by
device-memory bytes.

- ``bn_act``: on CUDA tensors one kernel launch or the call raises; the
  map is read in place through its strides (NCHW or NHWC dense with 16-byte
  loads, any other layout one element a thread).  On CPU (and meta)
  tensors the plain version.
- ``bn_act_plain``: the same arithmetic as eager torch ops; only CPU
  tensors take it in the wrapper, and on the card it is what the kernel
  is compared with, bit for bit.
- ``launches``: kernel launches so far; a map with no element reaches the
  launcher, which launches nothing and says so, and does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chessvision_tpu_torch import cuda_build

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
# a launcher's return when the map holds no element
_NOTHING_LAUNCHED = -1


def bn_act_plain(
    x: torch.Tensor,
    mean: torch.Tensor,
    mul: torch.Tensor,
    bias: torch.Tensor,
    residual: torch.Tensor | None = None,
    relu: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``((x.float() − mean) · mul + bias [+ residual])``, ReLU where asked,
    cast to ``out_dtype``: each step one eager op, rounded as it goes."""
    t = (x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    if residual is not None:
        t = t + residual
    if relu:
        t = t.relu()
    return t.to(out_dtype)


def _check(x, mean, mul, bias, residual, out_dtype) -> None:
    if x.ndim != 4 or x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"bn_act takes a 4-D bf16 or float32 map into bf16 or float32, got {x.dtype} "
                        f"{tuple(x.shape)} into {out_dtype}")
    c = x.shape[1]
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bn_act: {name} must be contiguous float32 ({c},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != torch.float32
                                 or residual.device != x.device):
        raise ValueError(f"bn_act: residual must be float32 {tuple(x.shape)} on {x.device}, got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")


def _dense_format(x: torch.Tensor, residual: torch.Tensor | None) -> torch.memory_format | None:
    """The memory format in which ``x`` (and ``residual``) are dense and
    16-byte aligned, or None."""
    for fmt in (torch.contiguous_format, torch.channels_last):
        if x.is_contiguous(memory_format=fmt) and (residual is None or residual.is_contiguous(memory_format=fmt)):
            if all(t.data_ptr() % 16 == 0 for t in (x, residual) if t is not None):
                return fmt
            return None
    return None


@functools.cache
def _kernel():
    fn = cuda_build.load("bn_act").bn_act_launch
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i64,
                   i64, i64, i64, i64, i64, i64, i64, i64, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, mean, mul, bias, residual, relu, out_dtype) -> torch.Tensor:
    global launches
    b, c, h, w = x.shape
    fmt = _dense_format(x, residual)
    out = torch.empty_like(x, dtype=out_dtype, memory_format=fmt or torch.contiguous_format)
    inner = h * w if fmt is torch.contiguous_format else 1
    res_strides = residual.stride() if residual is not None else (0, 0, 0, 0)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                 residual.data_ptr() if residual is not None else None, out.data_ptr(),
                 int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(relu),
                 b, c, h, w, int(fmt is not None), inner, *x.stride(), *res_strides,
                 torch.cuda.current_stream().cuda_stream)
    if err == _NOTHING_LAUNCHED:
        return out
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err}")
    launches += 1
    return out


def bn_act(
    x: torch.Tensor,
    mean: torch.Tensor,
    mul: torch.Tensor,
    bias: torch.Tensor,
    residual: torch.Tensor | None = None,
    relu: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BatchNorm on the running statistics (``mean``, ``mul`` = rsqrt(var +
    eps) · weight, ``bias``: float32 (C,)) of an NCHW map ``x`` (bf16 or
    float32), plus a float32 ``residual``, ReLU where asked, in ``out_dtype``.
    CUDA tensors go through the kernel or the call raises; CPU tensors take
    the plain version, and so do meta tensors (shapes only: the FLOP counts
    of ``tools/flops.py``); any other device raises."""
    _check(x, mean, mul, bias, residual, out_dtype)
    if x.is_cuda:
        if max(x.shape) >= 2**31:
            raise ValueError(f"bn_act kernel: shape {tuple(x.shape)} over the int32 dimension limit")
        return _launch(x, mean, mul, bias, residual, relu, out_dtype)
    if x.device.type in ("cpu", "meta"):
        return bn_act_plain(x, mean, mul, bias, residual, relu, out_dtype)
    raise ValueError(f"bn_act: unsupported device {x.device}")
