"""The threshold mask of the segmentation logits, decided where they lie.

The engine returns the JAX package's host formula, bit for bit
(``formula``; ``chessvision_tpu/engine.py``, ``Engine.process_batch``):

    mask = 255 where 1 / (1 + exp(-x)) > t, in float32 numpy, else 0.

Evaluating it over a batch costs the host 80–90 ms at B=128 (8.4 M ``exp``
on one thread).  Up to rounding the formula is monotone in x, so comparing
the logit with c = ln(t / (1 − t)) decides it everywhere except in a
narrow band around c.  ``band(t)`` gives float32 edges lo < c < hi such
that x > hi gives 255 and x <= lo gives 0 exactly; ``binary_mask`` makes
that split where the logits lie, and counts and lists the pixels in
(lo, hi], which the host then settles with the formula itself
(``engine._binary_mask``).

Why the band covers the formula's rounding.  Write s(x) = 1 / (1 + e^-x),
exact.  The formula computes e = exp(-x)(1 + d1), 1 + e rounded (d2) and
the quotient rounded (d3), so p / s(x) = (1 + d3) / ((1 + d2)(1 + (1 − s)
d1)) and |p / s − 1| <= |d1| + |d2| + |d3| + O(2^-36).  Taking |d1| <=
2^-18 (64 float32 ulps; numpy's float32 ``exp`` is documented within a
few, libm's ``expf`` within one) and |d2|, |d3| <= 2^-24, and allowing the
threshold its float32 rounding (2^-24; the comparison may see t or
float32(t)), the decision is the exact one wherever s(x) > t (1 + R) or
s(x) < t (1 − R) with R = 2^-18 + 3·2^-24 + O(2^-36) < 2^-17.9.  The band
takes REL = 2^-16, 3.7 times R: lo = logit(t (1 − REL)) and
hi = logit(t (1 + REL)), in float64 (its rounding, ~1e-16 relative, is
inside the slack), then rounded outwards to float32, since the logits are
float32.  Near p = 1 the sum 1 + e rounds to 1 (x > 17.4) and p = 1 > t;
below x = −87.3 the quotient is subnormal or 0, far under any t the split
takes.  At t = 0.5 the band is (−3.05e-5, 3.05e-5].

The split applies for 2^-100 <= t and t (1 + REL) < 1, where both edges
are finite and every p the argument compares is a normal float32;
``band`` returns None for any other threshold (outside (0, 1), NaN), and
the host evaluates the formula over the whole array.

- ``binary_mask``: CUDA float32 tensors go through one launch of
  ``csrc/mask.cu`` or the call raises; CPU (and meta) tensors take the
  plain version; any other device raises.
- ``binary_mask_plain``: the same split in torch ops: the CPU's path, and
  on the card what the kernel is compared with, bit for bit.
- ``launches``: kernel launches so far; a call with no logit reaches the
  launcher, which launches nothing and says so, and does not count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from chessvision_tpu_torch import cuda_build

# the band's half-width relative to the threshold (module docstring)
REL = 2.0 ** -16
# the least threshold the split takes (module docstring)
T_MIN = 2.0 ** -100
# band pixels whose flat indices ``binary_mask`` lists; the host finds any
# beyond them by scanning the logits
BAND_LIST = 4096

# the launcher's return when there is nothing to threshold
_NOTHING_LAUNCHED = -1

launches = 0


def formula(logits: np.ndarray, threshold: float) -> np.ndarray:
    """The host formula: uint8 255 where 1 / (1 + exp(-x)) > threshold in
    float32 numpy, else 0 (the JAX package's, after its copy back)."""
    with np.errstate(over="ignore"):
        probs = 1.0 / (1.0 + np.exp(-logits, dtype=np.float32))
        return np.where(probs > threshold, np.uint8(255), np.uint8(0))


def _logit(q: float) -> float:
    return math.log(q) - math.log1p(-q)


def _float32_down(v: float) -> float:
    """The largest float32 at or below ``v``."""
    f = np.float32(v)
    return float(np.nextafter(f, np.float32(-np.inf)) if float(f) > v else f)


def _float32_up(v: float) -> float:
    """The smallest float32 at or above ``v``."""
    f = np.float32(v)
    return float(np.nextafter(f, np.float32(np.inf)) if float(f) < v else f)


def band(threshold: float) -> tuple[float, float] | None:
    """(lo, hi), float32 values, outside which comparing the logit decides
    ``formula`` at ``threshold``: x > hi gives 255, x <= lo gives 0.  None
    where the split does not apply (module docstring)."""
    t = float(threshold)
    if not (T_MIN <= t and t * (1.0 + REL) < 1.0):
        return None
    return _float32_down(_logit(t * (1.0 - REL))), _float32_up(_logit(t * (1.0 + REL)))


def binary_mask_plain(logits: torch.Tensor, lo: float, hi: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, band): uint8 255 where ``logits`` > hi, else 0; and int32
    (1 + BAND_LIST,): the count of the logits in (lo, hi], then the flat
    indices of the first ``BAND_LIST`` of them in ascending order, and 0
    after.  In torch ops."""
    mask = (logits > hi).to(torch.uint8) * 255
    inside = torch.nonzero(((logits > lo) & (logits <= hi)).flatten()).flatten()
    band = torch.zeros(1 + BAND_LIST, dtype=torch.int32, device=logits.device)
    band[0] = len(inside)
    listed = inside[:BAND_LIST]
    band[1 : 1 + len(listed)] = listed.to(torch.int32)
    return mask, band


@functools.cache
def _kernel():
    fn = cuda_build.load("mask").mask_threshold_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(logits: torch.Tensor, lo: float, hi: float) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    if not logits.is_contiguous() or logits.data_ptr() % 16:  # the kernel reads float4
        logits = logits.clone(memory_format=torch.contiguous_format)
    mask = torch.empty(logits.shape, dtype=torch.uint8, device=logits.device)
    band = torch.empty(1 + BAND_LIST, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        err = _kernel()(logits.data_ptr(), mask.data_ptr(), band.data_ptr(), logits.numel(), BAND_LIST, lo, hi,
                        torch.cuda.current_stream().cuda_stream)
    if err == _NOTHING_LAUNCHED:
        return mask, band
    if err != 0:
        raise RuntimeError(f"mask threshold kernel launch failed: cudaError {err}")
    launches += 1
    return mask, band


def binary_mask(logits: torch.Tensor, lo: float, hi: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``binary_mask_plain`` of float32 logits of any shape: CUDA tensors
    go through the kernel (one launch; none where there is no logit) or the
    call raises; CPU and meta tensors take the plain version; any other
    device raises.  The kernel lists the band's first ``BAND_LIST`` pixels
    in the order they arrive, and leaves the list's unused slots as they
    were: the count and the set of listed indices are the plain version's
    where the count is at most ``BAND_LIST``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"binary_mask takes float32 logits, got {logits.dtype}")
    if logits.numel() >= 2 ** 31:
        raise ValueError(f"binary_mask indexes in int32: {logits.numel()} logits are too many")
    if logits.is_cuda:
        return _launch(logits, lo, hi)
    if logits.device.type in ("cpu", "meta"):
        return binary_mask_plain(logits, lo, hi)
    raise ValueError(f"binary_mask: unsupported device {logits.device}")
