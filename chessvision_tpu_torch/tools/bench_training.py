"""Training throughput on the card: step time, images/s and the projected
epoch of both trainers at their shipping configurations, the counterpart of
``scripts/bench_training.py``.

- UNet: base 32, B=32, 256², RMSprop (lr 3e-5, weight decay 1e-8,
  momentum 0.999, clipped at global norm 1); ``--quick``: base 8, B=4, 64².
- ResNet18: width 64, B=256 (``--quick`` 16, ``--cls-batch``), 64², Adam
  (lr 1e-3), with ``augment_classification_batch`` each step (K1 runs
  there; ``--no-augment`` leaves it out to attribute the step's time).

Steps run on seeded device-resident batches, bfloat16 convolutions over
float32 master weights on the card (float32 on the CPU): forward,
backward and update, the part the trainers repeat; host data loading is
not timed.  The clock stops on a synchronize of the card.

    python -m chessvision_tpu_torch.tools.bench_training [--quick] [--trainer unet|classifier|both] [--device cpu]

Prints one JSON line a trainer.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable

import torch

from chessvision_tpu_torch import models
from chessvision_tpu_torch.models.layers import set_compute_dtype
from chessvision_tpu_torch.profiling import _sync
from chessvision_tpu_torch.tools import card
from chessvision_tpu_torch.train import steps
from chessvision_tpu_torch.train.augment import augment_classification_batch, fold_in
from chessvision_tpu_torch.utils import default_train_dtype, resolve_device

# the train splits of the shipping datasets: 631 board-extraction images
# × 90%, and 8 931 training squares
N_TRAIN_SEG = 567
N_TRAIN_CLS = 8931
WARMUP_STEPS = 2

Batch = Callable[[int], tuple[torch.Tensor, torch.Tensor]]


def unet_optimizer() -> steps.Transform:
    return steps.make_optimizer("rmsprop", 3e-5, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0)


def cls_optimizer() -> steps.Transform:
    return steps.make_optimizer("adam", 1e-3)


def train_state(model: torch.nn.Module, tx: steps.Transform, device: torch.device) -> steps.TrainState:
    model = set_compute_dtype(model, default_train_dtype(device), master_weights=True).to(device)
    return steps.TrainState.create(model, tx)


def unet_setup(quick: bool, device: torch.device, seed: int = 0) -> tuple[steps.TrainState, Any, Batch]:
    """The UNet trainer's state, step and batches (one seeded batch, every
    step)."""
    batch, size, base = (4, 64, 8) if quick else (32, 256, 32)
    torch.manual_seed(seed)
    state = train_state(models.UNet(base=base), unet_optimizer(), device)
    g = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.rand((batch, size, size, 3), generator=g, device=device)
    masks = (torch.rand((batch, size, size), generator=g, device=device) > 0.5).float()
    return state, steps.make_seg_train_step(), lambda i: (imgs, masks)


def cls_setup(quick: bool, device: torch.device, seed: int = 0, batch: int | None = None,
              augment: bool = True) -> tuple[steps.TrainState, Any, Batch]:
    """The classifier trainer's state, step and batches (one seeded batch,
    augmented anew each step unless ``augment`` is off)."""
    batch = batch or (16 if quick else 256)
    torch.manual_seed(seed)
    state = train_state(models.resnet18(width=64), cls_optimizer(), device)
    g = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.rand((batch, 64, 64, 1), generator=g, device=device)
    labels = torch.arange(batch, device=device) % 13
    if not augment:
        return state, steps.make_cls_train_step(), lambda i: (imgs, labels)
    return state, steps.make_cls_train_step(), lambda i: (augment_classification_batch(fold_in(seed, i), imgs), labels)


def step_seconds(state: steps.TrainState, step: Any, batch: Batch, iters: int, device: torch.device) -> float:
    """Mean seconds a step over ``iters`` steps after the warm-up ones
    (cuDNN's algorithm choice), the clock stopped by a synchronize."""
    for i in range(WARMUP_STEPS):
        step(state, *batch(i))
    _sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        step(state, *batch(WARMUP_STEPS + i))
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _record(trainer: str, batch: int, size: int, dt: float, n_train: int, epochs: int, device: torch.device) -> dict:
    steps_per_epoch = n_train // batch
    return {
        "trainer": trainer,
        "batch_size": batch,
        "image_size": size,
        "step_ms": round(dt * 1000, 2),
        "images_per_sec": round(batch / dt, 1),
        "steps_per_epoch": steps_per_epoch,
        "epoch_s_projected": round(dt * steps_per_epoch, 1),
        f"epochs_{epochs}_min_projected": round(dt * steps_per_epoch * epochs / 60, 1),
        "backend": device.type,
        **card.card_fields(device),
    }


def bench_unet(quick: bool, device: torch.device, seed: int = 0) -> dict:
    state, step, batch = unet_setup(quick, device, seed)
    imgs, _ = batch(0)
    dt = step_seconds(state, step, batch, 3 if quick else 20, device)
    return _record("unet", imgs.shape[0], imgs.shape[1], dt, N_TRAIN_SEG, 20, device)


def bench_classifier(quick: bool, device: torch.device, seed: int = 0, batch: int | None = None,
                     augment: bool = True) -> dict:
    state, step, batches = cls_setup(quick, device, seed, batch, augment)
    imgs, _ = batches(0)
    dt = step_seconds(state, step, batches, 3 if quick else 20, device)
    return _record("classifier", imgs.shape[0], 64, dt, N_TRAIN_CLS, 10, device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Train-step throughput of the PyTorch port (one JSON line a trainer)")
    ap.add_argument("--quick", action="store_true", help="tiny config for smoke runs")
    ap.add_argument("--trainer", choices=["unet", "classifier", "both"], default="both")
    ap.add_argument("--cls-batch", type=int, default=None, help="override classifier batch size")
    ap.add_argument("--no-augment", action="store_true", help="skip on-device augmentation (attribution)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.trainer in ("unet", "both"):
        print(json.dumps(bench_unet(args.quick, dev)), flush=True)
    if args.trainer in ("classifier", "both"):
        rec = bench_classifier(args.quick, dev, batch=args.cls_batch, augment=not args.no_augment)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
