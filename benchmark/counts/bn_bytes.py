"""The bytes that inference BatchNorm with its activation needs, a board.

The port's ``bn_act`` reads each BatchNorm's input once (the convolution's
output, in the compute dtype), its residual once where there is one
(float32), the per-channel mean, multiplier and bias (float32), and writes
its output once in the dtype its reader takes.  Which output is stored in
which dtype follows the models' inference contract, which each
architecture's file states in its ``bn_out_item``
(``reference/archs/<model_id>.py``).  The shapes come from a recording
forward of the reference models; a board is one segmenter input and two
classifier passes over its 64 squares."""

from __future__ import annotations

from typing import Callable

import torch

from benchmark.reference import models

_ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _out_item(model_id: str) -> Callable[[str, int], tuple[int, int]]:
    """``bn_out_item`` of ``model_id``'s architecture; raises for a model
    without ``bn_act``."""
    out_item = getattr(models.arch(model_id), "bn_out_item", None)
    if out_item is None:
        raise ValueError(f"{model_id} runs no bn_act")
    return out_item


def bn_act_bytes_per_board(reference, dtype: str) -> float:
    """Bytes a board of every ``bn_act`` call of the configuration's models."""
    act = _ITEM[dtype]
    cfg = reference.config["models"]
    total = 0.0
    dev = reference.device
    runs = (
        (reference.ex, reference.ex_fn, cfg["extractor"]["model_id"], torch.zeros((1, 256, 256, 3), device=dev), 1),
        (reference.cl, reference.cl_fn, cfg["classifier"]["model_id"], torch.zeros((64, 64, 64, 1), device=dev), 2),
    )
    for layers, fn, model_id, x, passes in runs:
        layers.ops, layers.recording = [], True
        try:
            with torch.inference_mode():
                fn(layers, x)
        finally:
            layers.recording = False
        for _, path, shape in layers.ops:
            numel = 1
            for s in shape:
                numel *= s
            out, res = _out_item(model_id)(path, act)
            total += passes * (numel * (act + out + res) + 3 * 4 * shape[1])
        layers.ops = []
    return total
