"""Per-sample metrics collectors, the counterpart of
``chessvision_tpu/runstore/metrics.py``: plain functions over a batch's
model outputs on the device, returning small per-sample vectors;
``to_numpy`` brings them to the host.

 - per-sample segmentation loss (BCE + dice) and its parts;
 - segmentation quality of the thresholded mask (IoU, pixel accuracy);
 - classification loss / prediction / confidence / correctness;
 - top-2 margin and entropy of the class probabilities.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from chessvision_tpu_torch.train import losses


def segmentation_loss_per_sample(logits: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
    bce = losses.bce_with_logits_per_sample(logits, targets)
    dice = losses.dice_loss_per_sample(torch.sigmoid(logits), targets)
    return {"loss": bce + dice, "bce": bce, "dice_loss": dice}


def segmentation_quality(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> dict[str, torch.Tensor]:
    pred = (torch.sigmoid(logits) > threshold).float()
    dims = tuple(range(1, pred.ndim))
    inter = torch.sum(pred * targets, dim=dims)
    union = torch.sum(torch.maximum(pred, targets), dim=dims)
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-9), torch.ones_like(inter))
    acc = torch.mean((pred == targets).float(), dim=dims)
    return {"iou": iou, "pixel_accuracy": acc}


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    probs = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits, dim=-1)
    return {
        "loss": losses.softmax_cross_entropy_per_sample(logits, labels),
        "predicted": pred.to(torch.int32),
        "confidence": torch.max(probs, dim=-1).values,
        "correct": (pred == labels).to(torch.int32),
    }


def top2_margin_and_entropy(probs: torch.Tensor) -> dict[str, torch.Tensor]:
    top2 = torch.topk(probs, 2, dim=-1).values
    entropy = -torch.sum(probs * torch.log(torch.clamp(probs, 1e-12, 1.0)), dim=-1)
    return {"top_2_confidence_difference": top2[..., 0] - top2[..., 1], "prediction_entropy": entropy}


def to_numpy(metrics: dict[str, Any]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in metrics.items()}
