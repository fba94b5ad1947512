"""Result types of the PyTorch port, field for field those of
``chessvision_tpu/cv_types.py``: host numpy arrays, so callers of either
package read the same fields."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class ValidationFix:
    """Record of a validation rule fix applied to a position."""

    square_name: str
    original_piece: str
    corrected_piece: str
    rule_name: str


@dataclass
class BoardExtractionResult:
    """Results from the board extraction stage."""

    probabilities: np.ndarray  # raw logits (256, 256) float32
    binary_mask: np.ndarray  # thresholded mask (256, 256) uint8 in {0, 255}
    quadrangle: np.ndarray | None  # (4, 2) float32 in original-image coords
    board_image: np.ndarray | None  # (512, 512) uint8 grayscale, or None


@dataclass
class PositionResult:
    """Results from position classification including validation."""

    fen: str  # final FEN after validation
    original_fen: str  # FEN before validation
    model_probabilities: np.ndarray  # (64, 13) float32
    squares: np.ndarray  # (64, 64, 64, 1) uint8
    square_names: list[str]
    validation_fixes: list[ValidationFix]

    @property
    def confidence_scores(self) -> np.ndarray:
        """Per-square max probability."""
        return np.max(self.model_probabilities, axis=1)


@dataclass
class ChessVisionResult:
    """Complete results from single-image processing."""

    board_extraction: BoardExtractionResult
    position: PositionResult | None
    processing_time: float


@dataclass
class ValidationMetrics:
    """Metrics comparing position accuracy before and after validation."""

    accuracy_before: float
    accuracy_after: float
    num_fixes: int
    fixes: list[ValidationFix]

    @property
    def accuracy_delta(self) -> float:
        return self.accuracy_after - self.accuracy_before


@dataclass
class BatchResult:
    """Host-side view of one batched engine invocation.

    Arrays are stacked over the batch dimension; ``board_found[i]`` is False
    where no quadrangle passed the contour filters.
    """

    logits: np.ndarray  # (B, 256, 256) float32 — segmentation logits
    binary_mask: np.ndarray  # (B, 256, 256) uint8
    quadrangle: np.ndarray  # (B, 4, 2) float32, original-image coords
    board_found: np.ndarray  # (B,) bool
    board_image: np.ndarray  # (B, 512, 512) uint8
    probabilities: np.ndarray  # (B, 64, 13) float32
    fens: list[str] = field(default_factory=list)
    original_fens: list[str] = field(default_factory=list)
    validation_fixes: list[list[ValidationFix]] = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)
