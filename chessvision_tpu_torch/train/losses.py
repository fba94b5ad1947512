"""Loss functions, the counterpart of ``chessvision_tpu/train/losses.py``:
the segmentation objective BCE-with-logits plus dice (milesial semantics)
and the classifier's cross entropy with optional label smoothing, written
to optax's definitions."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise ``optax.sigmoid_binary_cross_entropy``:
    ``-t·log σ(x) − (1 − t)·log σ(−x)``."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy from logits."""
    return sigmoid_binary_cross_entropy(logits, targets).mean()


def _dice_terms(probs: torch.Tensor, targets: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    inter = 2.0 * torch.sum(probs * targets, dim=dims)
    sets_sum = torch.sum(probs, dim=dims) + torch.sum(targets, dim=dims)
    # an empty prediction on an empty target counts as a perfect match
    sets_sum = torch.where(sets_sum == 0, inter, sets_sum)
    return inter, sets_sum


def dice_coefficient(
    probs: torch.Tensor, targets: torch.Tensor, *, epsilon: float = 1e-6, reduce_batch_first: bool = False
) -> torch.Tensor:
    """Dice per item over all non-batch dims, then averaged (or over the
    whole batch with ``reduce_batch_first``)."""
    dims = tuple(range(probs.ndim)) if reduce_batch_first else tuple(range(1, probs.ndim))
    inter, sets_sum = _dice_terms(probs, targets, dims)
    return torch.mean((inter + epsilon) / (sets_sum + epsilon))


def dice_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return 1.0 - dice_coefficient(probs, targets)


def dice_loss_per_sample(probs: torch.Tensor, targets: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    inter, sets_sum = _dice_terms(probs, targets, tuple(range(1, probs.ndim)))
    return 1.0 - (inter + epsilon) / (sets_sum + epsilon)


def bce_with_logits_per_sample(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return sigmoid_binary_cross_entropy(logits, targets).mean(dim=tuple(range(1, logits.ndim)))


def segmentation_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE + dice, the reference's training objective."""
    return bce_with_logits(logits, targets) + dice_loss(torch.sigmoid(logits), targets)


def softmax_cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``."""
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels; with smoothing the
    targets are ``one_hot·(1 − ε) + ε/n``."""
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        targets = F.one_hot(labels.long(), n).float() * (1.0 - label_smoothing) + label_smoothing / n
        return torch.mean(-torch.sum(targets * F.log_softmax(logits, dim=-1), dim=-1))
    return softmax_cross_entropy_per_sample(logits, labels).mean()
