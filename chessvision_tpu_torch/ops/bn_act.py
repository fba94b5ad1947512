"""Inference BatchNorm + residual + activation in one pass, written once.

``out = act((x − mean) · mul + bias [+ residual])`` in float32, in Flax's
order (``flax.linen.normalization._normalize``; ``mul = rsqrt(var + eps) ·
weight``), stored in ``out_dtype``; ``act`` is none, ReLU or SiLU
(``t / (1 + exp(−t))``, torch's float32 formula), and the residual (float32
or bf16) may instead be added after the activation (``act(bn(x)) +
residual``: the YOLO family's Bottleneck, whose last convolution ends in
SiLU).  The epilogue is the argument ``act``, a name of ``EPILOGUES``.  It
has no TPU kernel behind it: in the
JAX package XLA fuses BatchNorm, the residual sum, the ReLU and the cast to
the next convolution's dtype, so no float32 map is stored; eager PyTorch
stores three.  The kernel is hand-written CUDA, ``csrc/bn_act.cu``, bound by
device-memory bytes.

- ``bn_act``: on CUDA tensors one kernel launch or the call raises; the
  map is read in place through its strides (NCHW or NHWC dense with 16-byte
  loads, any other layout one element a thread; a residual that is a
  channel slice of a dense map is read in place too).  On CPU (and meta)
  tensors the plain version.
- ``bn_act_plain``: the same arithmetic as eager torch ops; only CPU
  tensors take it in the wrapper, and on the card it is what the kernel
  is compared with, bit for bit.
- ``launches``: kernel launches so far, and ``silu_launches`` those of
  them with a SiLU epilogue; a map with no element reaches the launcher,
  which launches nothing and says so, and does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from chessvision_tpu_torch import cuda_build

launches = 0
silu_launches = 0

# epilogue name → (activation code of csrc/bn_act.cu, residual after the activation)
EPILOGUES = {
    "none": (0, False),
    "relu": (1, False),
    "silu": (2, False),
    "silu+res": (2, True),
}

_DTYPES = (torch.bfloat16, torch.float32)
# a launcher's return when the map holds no element
_NOTHING_LAUNCHED = -1


def epilogue(act: str) -> tuple[int, bool]:
    """(activation code, residual after the activation) of the epilogue
    ``act``."""
    if act not in EPILOGUES:
        raise ValueError(f"bn_act: unknown epilogue {act!r}; have {sorted(EPILOGUES)}")
    return EPILOGUES[act]


def bn_act_plain(
    x: torch.Tensor,
    mean: torch.Tensor,
    mul: torch.Tensor,
    bias: torch.Tensor,
    residual: torch.Tensor | None = None,
    act: str = "none",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(x.float() − mean) · mul + bias``, the residual added before or
    after the activation ``act`` asks for, cast to ``out_dtype``: each step
    one eager op, rounded as it goes."""
    code, after = epilogue(act)
    t = (x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    if residual is not None and not after:
        t = t + residual
    if code == 1:
        t = t.relu()
    elif code == 2:
        t = t / (1.0 + torch.exp(-t))
    if residual is not None and after:
        t = t + residual
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
    if residual is not None and (residual.shape != x.shape or residual.dtype not in _DTYPES
                                 or residual.device != x.device):
        raise ValueError(f"bn_act: residual must be bf16 or float32 {tuple(x.shape)} on {x.device}, got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")


def _dense_format(x: torch.Tensor) -> torch.memory_format | None:
    """The memory format in which ``x`` is dense and 16-byte aligned, or
    None."""
    for fmt in (torch.contiguous_format, torch.channels_last):
        if x.is_contiguous(memory_format=fmt):
            return fmt if x.data_ptr() % 16 == 0 else None
    return None


def _strides_match(t: torch.Tensor, want: tuple[int, ...]) -> bool:
    """``t``'s strides are ``want`` on every axis longer than 1."""
    return all(n == 1 or s == w for n, s, w in zip(t.shape, t.stride(), want))


def _residual_blocks(residual: torch.Tensor, fmt: torch.memory_format) -> tuple[int, int] | None:
    """(block, pitch): the residual is dense in blocks of ``block`` elements
    ``pitch`` elements apart, in the order of a map dense in ``fmt``, with
    16-byte loads of 8 elements; or None.  A dense residual is one block;
    a channel slice of a dense NCHW map one block a batch item, of an NHWC
    map one a pixel."""
    b, c, h, w = residual.shape
    n = residual.numel()
    if residual.data_ptr() % 16:
        return None
    if fmt is torch.contiguous_format:
        if not _strides_match(residual, (residual.stride(0), h * w, w, 1)):
            return None
        block, pitch = c * h * w, residual.stride(0) if b > 1 else c * h * w
    else:
        # the residual's elements from one pixel to the next
        pitch = residual.stride(3) if w > 1 else residual.stride(2) if h > 1 else residual.stride(0) if b > 1 else c
        if not _strides_match(residual, (h * w * pitch, 1, w * pitch, pitch)):
            return None
        block = c
    if block * b == n and pitch == block:
        return n, n
    return (block, pitch) if block % 8 == 0 and pitch % 8 == 0 else None


@functools.cache
def _kernel():
    fn = cuda_build.load("bn_act").bn_act_launch
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i64,
                   i64, i64, i64, i64, i64, i64, i64, i64, i64, i64, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, mean, mul, bias, residual, act, out_dtype) -> torch.Tensor:
    global launches, silu_launches
    b, c, h, w = x.shape
    code, after = epilogue(act)
    fmt = _dense_format(x)
    blocks = (x.numel(), x.numel())
    if fmt is not None and residual is not None:
        blocks = _residual_blocks(residual, fmt)
        fmt = fmt if blocks is not None else None
    out = torch.empty_like(x, dtype=out_dtype, memory_format=fmt or torch.contiguous_format)
    inner = h * w if fmt is torch.contiguous_format else 1
    res_strides = residual.stride() if residual is not None else (0, 0, 0, 0)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                 residual.data_ptr() if residual is not None else None, out.data_ptr(),
                 int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), code,
                 int(residual is not None and residual.dtype == torch.bfloat16), int(after),
                 b, c, h, w, int(fmt is not None), inner, *(blocks or (1, 1)), *x.stride(), *res_strides,
                 torch.cuda.current_stream().cuda_stream)
    if err == _NOTHING_LAUNCHED:
        return out
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err}")
    launches += 1
    silu_launches += code == 2
    return out


def bn_act(
    x: torch.Tensor,
    mean: torch.Tensor,
    mul: torch.Tensor,
    bias: torch.Tensor,
    residual: torch.Tensor | None = None,
    act: str = "none",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BatchNorm on the running statistics (``mean``, ``mul`` = rsqrt(var +
    eps) · weight, ``bias``: float32 (C,)) of an NCHW map ``x`` (bf16 or
    float32), plus a bf16 or float32 ``residual`` before or after the
    activation, as the epilogue ``act`` says (``epilogue``), in ``out_dtype``.
    CUDA tensors go through the kernel or the call raises; CPU tensors take
    the plain version, and so do meta tensors (shapes only: the FLOP counts
    of ``tools/flops.py``); any other device raises."""
    _check(x, mean, mul, bias, residual, out_dtype)
    epilogue(act)
    if x.is_cuda:
        if max(x.shape) >= 2**31:
            raise ValueError(f"bn_act kernel: shape {tuple(x.shape)} over the int32 dimension limit")
        return _launch(x, mean, mul, bias, residual, act, out_dtype)
    if x.device.type in ("cpu", "meta"):
        return bn_act_plain(x, mean, mul, bias, residual, act, out_dtype)
    raise ValueError(f"bn_act: unsupported device {x.device}")
