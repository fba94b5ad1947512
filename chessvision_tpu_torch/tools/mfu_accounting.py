"""FLOP accounting and the share of the card's peak, the counterpart of
``scripts/mfu_accounting.py``.

Counts come from ``torch.utils.flop_counter.FlopCounterMode`` over the
port's own step and pipeline functions (``tools/flops.py``): the UNet
train step (base 32, 256²) at B=4 scaled to 32, the ResNet18 train step
(width 64, 64²) at B=32 scaled to 256, ``Engine.run_packed`` at B=4 a
board, and each model's forward for the attribution line.  The count is
linear in the batch, and it does not depend on the device.  Every kernel
tap of a convolution counts, padding included, as cuDNN's implicit GEMM
executes it; XLA's cost analysis, which the JAX script reads, counts only
the taps that land inside the input, so on the ResNet18's small maps it
counts less (``XLA_GFLOP`` and the in-bounds column).

Times are measured on the card by ``bench_training`` (the two steps),
``bench.compute_probe`` (``run_device`` at 8×128 boards on frames on the
card) and ``microbench.bench_warp`` (K1 at B=128); flags override them,
and a time given is not measured.  The warp's floor is counted from
``microbench``'s inputs (``microbench.warp_floor``) either way.
MFU = achieved FLOP/s ÷ the card's dense bf16 peak (``tools/card.py``).
The warp is a gather, so its row stands against its floor in bytes (the
source sectors its taps touch, at the card's memory rate), not a FLOP peak.

    python -m chessvision_tpu_torch.tools.mfu_accounting [--unet-step-ms MS] [--cls-step-ms MS]
        [--compute-boards-per-sec N] [--warp-ms-128 MS] [--refine MODE] [--device cpu]

On the CPU every time must be given.  Prints the table, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import numpy as np
import torch

from chessvision_tpu_torch import models
from chessvision_tpu_torch.tools import bench, bench_training, card, flops, microbench
from chessvision_tpu_torch.train import steps
from chessvision_tpu_torch.utils import default_train_dtype, resolve_device

# XLA's cost analysis of the JAX package's bf16 models on the CPU (GFLOP):
# the UNet (base 32) on one 256² frame and the ResNet18 (width 64) on the
# 64 squares of one board; tests/test_torch_measure.py recomputes both
XLA_GFLOP = {"unet_fwd": 23.656906752, "resnet18_fwd_64_squares": 13.7453568}
COUNT = ("FlopCounterMode over the port's functions: every convolution tap, padding included "
         "(XLA's cost analysis counts in-bounds taps only)")
SEG_BATCH, SEG_REF, CLS_BATCH, CLS_REF, PIPE_REF = 32, 4, 256, 32, 4


def train_step_flops(device: torch.device) -> dict[str, float]:
    """FLOPs of one UNet and one ResNet18 train step at the trainers'
    batches, counted at a smaller batch and scaled."""
    seg = bench_training.train_state(models.UNet(base=32), bench_training.unet_optimizer(), device)
    imgs = torch.zeros((SEG_REF, 256, 256, 3), device=device)
    unet = flops.counted_flops(steps.make_seg_train_step(), seg, imgs, imgs[..., 0]) * SEG_BATCH / SEG_REF
    cls = bench_training.train_state(models.resnet18(width=64), bench_training.cls_optimizer(), device)
    squares = torch.zeros((CLS_REF, 64, 64, 1), device=device)
    labels = torch.zeros((CLS_REF,), dtype=torch.int64, device=device)
    resnet = flops.counted_flops(steps.make_cls_train_step(), cls, squares, labels) * CLS_BATCH / CLS_REF
    return {"unet": unet, "resnet18": resnet}


def forward_flops(cv: Any) -> dict[str, dict[str, float]]:
    """Each model's forward at its pipeline shapes, in both counts."""
    ex, _ = cv.board_extractor
    cl, _ = cv.classifier
    out = {}
    for name, model, x in (("unet_fwd", ex, torch.zeros((1, 256, 256, 3), device=cv.device)),
                           ("resnet18_fwd_64_squares", cl, torch.zeros((64, 64, 64, 1), device=cv.device))):
        with torch.inference_mode():
            out[name] = {"all_taps": flops.counted_flops(model, x),
                         "in_bounds": flops.conv_flops(model, x, in_bounds=True)}
    return out


def measured_times(args: argparse.Namespace, cv: Any, device: torch.device) -> dict[str, Any]:
    """The four times, from the flags or measured on the card."""
    given = {"unet_step_ms": args.unet_step_ms, "cls_step_ms": args.cls_step_ms,
             "compute_boards_per_sec": args.compute_boards_per_sec, "warp_ms_128": args.warp_ms_128}
    if device.type != "cuda":
        missing = [k for k, v in given.items() if v is None]
        if missing:
            raise ValueError(f"on the CPU give every time: {missing} (this tool measures them on the card)")
        return {**given, "compute_batch_size": None, "warp_bound_ms": None}
    t = dict(given)
    if t["unet_step_ms"] is None:
        t["unet_step_ms"] = bench_training.bench_unet(False, device)["step_ms"]
    if t["cls_step_ms"] is None:
        t["cls_step_ms"] = bench_training.bench_classifier(False, device)["step_ms"]
    t["compute_batch_size"] = None
    if t["compute_boards_per_sec"] is None:
        frames, _ = bench.bench_frames(128, 0)
        rate, t["compute_batch_size"], err = bench.compute_probe(cv.engine, frames, 8 * 128, 6)
        if rate is None:
            raise RuntimeError(f"compute probe failed: {err}")
        t["compute_boards_per_sec"] = rate
    imgs, minv = microbench.warp_inputs(microbench.WARP_BATCH, 0, device)
    bytes_per_s = card.peaks(card.card_fields(device)["device"])["bytes_per_s"]
    t["warp_bound_ms"] = microbench.warp_floor(imgs, minv, microbench.CANVAS, microbench.CANVAS, bytes_per_s)[1]
    if t["warp_ms_128"] is None:
        warp = microbench.bench_warp(5, device)
        if warp["warp_max_abs_err"] != 0.0:
            raise RuntimeError(f"K1 differs from its plain version by {warp['warp_max_abs_err']}")
        t["warp_ms_128"] = warp["warp_twopass_ms"]
    return t


def table(train: dict[str, float], pipe: float, t: dict[str, Any], peak: float | None) -> list[dict[str, Any]]:
    """The rows: FLOPs, ms, TFLOP/s and share of the bf16 peak (the warp:
    its floor in bytes and the share of it reached)."""

    def row(stage: str, flop: float, seconds: float) -> dict[str, Any]:
        rate = flop / seconds
        return {"stage": stage, "gflop": flop / 1e9, "ms": seconds * 1e3, "tflop_per_s": rate / 1e12,
                "peak_share": rate / peak if peak else None, "bound_by": "operations"}

    at = f", B={t['compute_batch_size']}" if t["compute_batch_size"] else ""
    warp_ms, bound = t["warp_ms_128"], t["warp_bound_ms"]
    return [
        row(f"UNet train step (B={SEG_BATCH})", train["unet"], t["unet_step_ms"] / 1e3),
        row(f"ResNet18 train step (B={CLS_BATCH})", train["resnet18"], t["cls_step_ms"] / 1e3),
        row(f"pipeline per board (run_device{at})", pipe, 1.0 / t["compute_boards_per_sec"]),
        {"stage": "  warp, K1 (B=128, 512² to 576²)", "gflop": None, "ms": warp_ms, "tflop_per_s": None,
         "bound_ms": bound, "peak_share": bound / warp_ms if bound else None, "bound_by": "bytes"},
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="FLOPs and share of the card's peak of the PyTorch port")
    ap.add_argument("--unet-step-ms", type=float, default=None, help="UNet train step at B=32 (default: measured)")
    ap.add_argument("--cls-step-ms", type=float, default=None, help="ResNet18 train step at B=256 (default: measured)")
    ap.add_argument("--compute-boards-per-sec", type=float, default=None,
                    help="run_device on frames on the card (default: measured at B=1024 as bench_torch.py's probe "
                         "measures it, halved only on out-of-memory)")
    ap.add_argument("--warp-ms-128", type=float, default=None, help="K1 ms at B=128 (default: measured)")
    ap.add_argument("--refine", default=None, help="engine refine mode to account (default: the shipping default)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (every time given)")
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision

    dev = resolve_device(args.device)
    fields = card.card_fields(dev)
    peak = card.peaks(fields["device"])["bf16_flop_per_s"] if dev.type == "cuda" else None
    cv = ChessVision(lazy_load=False, device=dev, dtype=default_train_dtype(dev), refine_grid=args.refine)
    t = measured_times(args, cv, dev)
    train = train_step_flops(dev)
    pipe = flops.pipeline_flops_per_board(cv.engine, np.zeros((1, 512, 512, 3), np.uint8), PIPE_REF)
    fwd = forward_flops(cv)
    n_cls = 2 if cv.engine._refine == "arbitrate" else 1
    rows = table(train, pipe, t, peak)

    print(f"{'stage':<48} {'GFLOP':>9} {'ms':>9} {'TFLOP/s':>8} {'% peak':>7}")
    for r in rows:
        cells = [f"{r[k]:>9.2f}" if isinstance(r[k], float) else f"{'':>9}" for k in ("gflop", "ms")]
        rate = f"{r['tflop_per_s']:>8.2f}" if r["tflop_per_s"] is not None else f"{'':>8}"
        share = f"{100 * r['peak_share']:>6.1f} ({r['bound_by']})" if r["peak_share"] is not None else ""
        print(f"{r['stage']:<48} {' '.join(cells)} {rate} {share}")
    for name, c in fwd.items():
        print(f"{name}: {c['all_taps'] / 1e9:.3f} GFLOP all taps, {c['in_bounds'] / 1e9:.3f} in-bounds taps, "
              f"XLA (JAX package) {XLA_GFLOP[name]:.3f}")
    cls_total = n_cls * fwd["resnet18_fwd_64_squares"]["all_taps"]
    rest = pipe - fwd["unet_fwd"]["all_taps"] - cls_total
    print(f"pipeline {pipe / 1e9:.2f} GFLOP a board ({cv.engine._refine} mode): UNet fwd "
          f"{100 * fwd['unet_fwd']['all_taps'] / pipe:.0f}%, classifier ({n_cls} passes of 64 squares) "
          f"{100 * cls_total / pipe:.0f}%, rest (quad, warp positions, gridfix) {rest / 1e9:.2f} GFLOP")
    print(json.dumps({"rows": rows, "forward_gflop": {k: {m: v / 1e9 for m, v in c.items()} for k, c in fwd.items()},
                      "xla_gflop": XLA_GFLOP, "pipeline_gflop_per_board": pipe / 1e9, "refine": cv.engine._refine,
                      "times": t, "flop_count": COUNT, "backend": dev.type, **fields}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
