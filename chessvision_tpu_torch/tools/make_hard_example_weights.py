"""Write hard-example sample weights onto the classifier train table, the
counterpart of ``scripts/make_hard_example_weights.py``.

Runs the classifier (``--weights``, ResNet18 by default) over the training
squares (``train/data.py:load_squares``) in batches of 512, padded with
``pad_indices``, scores each example by the probability it gives the true
class, and saves a ``sample_weight`` column, ``w = 1 + boost · (1 −
p_true)`` normalized to mean 1, onto the registered train table
(``train/tables.py:get_or_create_classification_tables``).  The trainers
read it with ``--use-sample-weights``.

    python -m chessvision_tpu_torch.tools.make_hard_example_weights [--boost 9.0]
        [--weights weights/best_classifier.npz] [--device cuda|cpu]
        [--dtype bfloat16|float32] [--data-root DIR]

Runs on the GPU unless given ``--device cpu``; prints the JAX script's
summary line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from chessvision_tpu_torch import constants

BATCH = 512


def p_true(model: torch.nn.Module, images: np.ndarray, labels: np.ndarray, device: torch.device) -> np.ndarray:
    """The probability ``model`` gives each (64, 64) uint8 square's label,
    over batches of ``BATCH`` padded to that size."""
    from chessvision_tpu_torch.train import data as data_lib

    ps = []
    with torch.inference_mode():
        for idx in data_lib.batches(len(labels), BATCH):
            idx, real = data_lib.pad_indices(idx, BATCH)
            imgs = torch.from_numpy(images[idx]).to(device).float()[..., None] / 255.0
            labs = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
            probs = torch.softmax(model(imgs).float(), dim=-1)
            ps.append(probs.gather(1, labs[:, None])[:real, 0].cpu().numpy())
    return np.concatenate(ps)


def hard_example_weights(p: np.ndarray, boost: float) -> np.ndarray:
    """``1 + boost · (1 − p)``, normalized to mean 1."""
    w = 1.0 + boost * (1.0 - p)
    return w / w.mean()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Hard-example sample weights for the classifier (PyTorch)")
    ap.add_argument("--boost", type=float, default=9.0, help="weight multiplier at p_true=0")
    ap.add_argument("--weights", default=constants.BEST_CLASSIFIER_WEIGHTS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                    help="convolution dtype (default: bfloat16 on the GPU, float32 on the CPU)")
    ap.add_argument("--data-root", default=None, help="root holding squares/ (default: the data root)")
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import build_model
    from chessvision_tpu_torch.tools import card
    from chessvision_tpu_torch.train import data as data_lib
    from chessvision_tpu_torch.train.tables import get_or_create_classification_tables
    from chessvision_tpu_torch.utils import default_train_dtype, full_f32, resolve_device

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype) if args.dtype else default_train_dtype(dev)
    data = data_lib.load_squares(args.data_root)
    model, _ = build_model("classifier", "resnet18", args.weights, dtype, dev)
    with full_f32():
        p = p_true(model, data.train_images, data.train_labels, dev)

    w = hard_example_weights(p, args.boost)
    train = get_or_create_classification_tables(data_root=args.data_root)["train"]
    lookup = dict(zip(data.train_ids, w))
    aligned = np.asarray([lookup.get(e, 1.0) for e in train["example_id"]], np.float64)
    train.with_column("sample_weight", aligned).save()
    hard = int((p < 0.9).sum())
    print(
        f"wrote sample_weight to {train.url}: {len(aligned)} rows, "
        f"{hard} hard examples (p_true<0.9), weight range "
        f"[{aligned.min():.3f}, {aligned.max():.3f}]"
    )
    fields = card.card_fields(dev)
    print(f"device: {fields['device']}, power limit: {fields['power_limit_w']} W")
    return 0


if __name__ == "__main__":
    sys.exit(main())
