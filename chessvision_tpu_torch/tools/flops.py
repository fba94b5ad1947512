"""Work counted from shapes, for shares of a card's peak.

Two counts of a model's FLOPs: ``counted_flops`` runs any function under
``torch.utils.flop_counter.FlopCounterMode`` (every matmul and convolution
PyTorch dispatches, each kernel tap counted as cuDNN's implicit GEMM
executes it, padding included); ``conv_flops`` counts each convolution and
linear layer of one module from its shapes with forward hooks, the
independent check of the first, and with ``in_bounds`` only the taps that
land inside the input, as XLA's cost analysis counts a convolution.  K1 is
a gather whose arithmetic is not a matmul: on the CPU its plain version
dispatches no matmul and on the card the kernel is no PyTorch op, so
neither count includes it; ``tap_sector_bytes`` gives its floor in bytes,
and ``row_tap_sector_bytes`` the floor of one of its passes."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def counted_flops(fn: Callable[..., Any], *args: Any) -> float:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def pipeline_flops_per_board(engine: Any, frame: np.ndarray, n: int = 4, in_bounds: bool = False) -> float:
    """``counted_flops`` of ``engine.run_packed`` (the pipeline after the
    host packing; the raw path adds only the integer front half) on ``n``
    boards of zeros shaped as ``pack_inputs`` packs ``frame`` (1, H, W, 3),
    per board; ``in_bounds`` drops the taps of the engine's models'
    convolutions that read their zero padding (``conv_flops``).  Every
    stage is branch-free over the data, so zeros count what any frames
    cost."""
    from chessvision_tpu_torch.engine import pack_inputs

    comp, gray = (torch.zeros((n, *a.shape[1:]), dtype=torch.uint8, device=engine.device) for a in pack_inputs(frame))
    padding = [0.0]

    def hook(m: nn.Module, inp: tuple, out: torch.Tensor) -> None:
        padding[0] += _layer_flops(m, inp[0], out, False) - _layer_flops(m, inp[0], out, True)

    models = (engine._extractor, engine._classifier) if in_bounds else ()
    hooks = [m.register_forward_hook(hook) for model in models for m in model.modules() if isinstance(m, _LAYERS)]
    try:
        total = counted_flops(engine.run_packed, comp, gray)
    finally:
        for h in hooks:
            h.remove()
    return (total - padding[0]) / n


def _taps_inside(n_in: int, n_out: int, kernel: int, stride: int, pad: int) -> int:
    """Output positions × kernel taps along one axis that read the input
    (not its zero padding)."""
    return sum(1 for o in range(n_out) for t in range(kernel) if 0 <= o * stride - pad + t < n_in)


_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _layer_flops(m: nn.Module, x: torch.Tensor, out: torch.Tensor, in_bounds: bool) -> float:
    """Multiply-adds ×2 of one call of a convolution or linear layer on
    ``x``, from the shapes."""
    if isinstance(m, nn.ConvTranspose2d):
        return 2.0 * x.numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1] / m.groups
    if isinstance(m, nn.Conv2d):
        per_tap = 2.0 * out.shape[0] * m.out_channels * (m.in_channels // m.groups)
        if in_bounds:
            (hi, wi), (ho, wo) = x.shape[-2:], out.shape[-2:]
            return per_tap * (_taps_inside(hi, ho, m.kernel_size[0], m.stride[0], m.padding[0])
                              * _taps_inside(wi, wo, m.kernel_size[1], m.stride[1], m.padding[1]))
        return per_tap * out.shape[-2] * out.shape[-1] * m.kernel_size[0] * m.kernel_size[1]
    return 2.0 * out.numel() * m.in_features


def conv_flops(model: nn.Module, x: torch.Tensor, in_bounds: bool = False) -> float:
    """Multiply-adds ×2 of every convolution and linear layer in one forward
    of ``model`` on ``x``, from the shapes; ``in_bounds`` drops the taps
    that read a convolution's zero padding."""
    total = [0.0]

    def hook(m: nn.Module, inp: tuple, out: torch.Tensor) -> None:
        total[0] += _layer_flops(m, inp[0], out, in_bounds)

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, _LAYERS)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def tap_sector_bytes(imgs: torch.Tensor, hx: torch.Tensor, vy: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors of ``imgs`` (B, H, W) that the two-pass
    warp's boards depend on: for each board pixel the source rows of its
    nonzero pass-2 taps at ``vy`` (B, out_w, out_h), and in each such row
    the columns of its nonzero pass-1 taps at ``hx`` (B, H, out_w).  What a
    warp that read only its taps would move; the run's own positions."""
    b, h, w = imgs.shape
    n = torch.arange(b, device=vy.device)[:, None, None].expand_as(vy)
    u = torch.arange(vy.shape[1], device=vy.device)[None, :, None].expand_as(vy)
    sectors = []
    for dr in (0, 1):
        r = torch.floor(vy) + dr
        ok = (r >= 0) & (r < h) & (1.0 - torch.abs(vy - r) > 0)
        nn_, rr, uu = n[ok], r[ok].long(), u[ok]
        p = hx[nn_, rr, uu]
        for dc in (0, 1):
            c = torch.floor(p) + dc
            okc = (c >= 0) & (c < w) & (1.0 - torch.abs(p - c) > 0)
            flat = (nn_[okc] * h + rr[okc]) * w + c[okc].long()
            sectors.append(torch.unique((imgs.data_ptr() % 32 + 4 * flat) // 32))
    return 32 * int(torch.unique(torch.cat(sectors)).numel())


def row_tap_sector_bytes(src: torch.Tensor, pos: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors of ``src`` (B, R, J), read through its
    strides, that a hat resample of its rows at ``pos`` (B, R, U) reads:
    each nonzero tap's sector once.  One pass of the two-pass warp: pass 1
    on the images at hx, pass 2 on the intermediate's transposed view at
    vy."""
    b, rows, j = src.shape
    n = torch.arange(b, device=pos.device)[:, None, None].expand_as(pos)
    r = torch.arange(rows, device=pos.device)[None, :, None].expand_as(pos)
    sb, sr, sj = src.stride()
    sectors = []
    for d in (0, 1):
        c = torch.floor(pos) + d
        ok = (c >= 0) & (c < j) & (1.0 - torch.abs(pos - c) > 0)
        flat = n[ok] * sb + r[ok] * sr + c[ok].long() * sj
        sectors.append(torch.unique((src.data_ptr() % 32 + 4 * flat) // 32))
    return 32 * int(torch.unique(torch.cat(sectors)).numel())
