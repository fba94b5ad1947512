"""Inputs of the threshold mask's tests, on the CPU and on the card
(``tests/test_torch_mask.py``, ``tests/test_torch_cuda.py``): the host
formula the engine's mask must equal bit for bit, and logits that cover
the band of a threshold edge to edge.  Imports neither JAX nor the JAX
package."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from chessvision_tpu_torch.ops import mask as mask_ops

THRESHOLDS = (0.5, 0.3, 0.7, 0.9, 0.01, 0.99)
ULPS = 1 << 16


def old_formula(logits: np.ndarray, threshold: float) -> np.ndarray:
    """The JAX package's host mask (``chessvision_tpu/engine.py``,
    ``Engine.process_batch``), as it stands there: the card's tests cannot
    import that package, so they hold the port to this copy, which
    ``test_torch_mask.py`` holds to the package's own ``process_batch``."""
    with np.errstate(over="ignore"):
        probs_mask = 1.0 / (1.0 + np.exp(-logits, dtype=np.float32))
        return np.where(probs_mask > threshold, np.uint8(255), np.uint8(0))


def _around(v: float, ulps: int = ULPS) -> np.ndarray:
    """Every float32 within ``ulps`` steps of ``v`` (rounded to float32)."""
    f = np.float32(v)
    bits = np.int64(np.abs(f).view(np.int32))
    mag = np.arange(bits - ulps, bits + ulps + 1)
    mag = mag[(mag >= 0) & (mag < 0x7F800000)].astype(np.int32).view(np.float32)
    return mag if f >= 0 else -mag


def _specials() -> np.ndarray:
    big = np.finfo(np.float32).max
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, big, -big, 3.4e38, -3.4e38], np.float32)


def edge_logits(threshold: float) -> np.ndarray:
    """(B, 256, 256) float32: every float32 within 2^16 ulps of each band
    edge and of c = logit(t), the specials, and seeded logits across
    [-40, 40], padded with seeded ones."""
    lo, hi = mask_ops.band(threshold)
    c = np.log(threshold / (1 - threshold))
    rng = np.random.default_rng(22)
    flat = np.concatenate([_around(lo), _around(hi), _around(c), _specials(),
                           rng.uniform(-40, 40, 100_000).astype(np.float32)])
    pad = (-len(flat)) % (256 * 256)
    flat = np.concatenate([flat, rng.uniform(-40, 40, pad).astype(np.float32)])
    return flat.reshape(-1, 256, 256)


def listed(band: torch.Tensor) -> list[int]:
    """The flat indices a band (``mask_ops.binary_mask``'s second output)
    lists, in ascending order: the kernel lists them as they arrive."""
    n = min(int(band[0]), mask_ops.BAND_LIST)
    return sorted(band[1 : 1 + n].tolist())


# the planted values in (lo, hi]: all but lo and the float32 after hi
PLANTED_IN_BAND = 6


class PlantedExtractor(nn.Module):
    """Two boards: a square at +8, the rest at −8, and on the second board
    a row of values about c = 0 of t = 0.5: each band edge, the float32
    after it, ±0 and ±1e-30 (``PLANTED_IN_BAND`` of them in (lo, hi])."""

    def __init__(self) -> None:
        super().__init__()
        logits = np.full((256, 256), -8.0, np.float32)
        logits[40:216, 40:216] = 8.0
        lo, hi = mask_ops.band(0.5)
        row = [lo, np.nextafter(np.float32(lo), np.float32(1)), 0.0, -0.0, 1e-30, -1e-30, hi,
               np.nextafter(np.float32(hi), np.float32(1))]
        planted = np.stack([logits, logits])
        planted[1, 120, 20:20 + len(row)] = np.array(row, np.float32)
        self.register_buffer("logits", torch.from_numpy(planted))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits[: x.shape[0], :, :, None]


class FlatClassifier(nn.Module):
    """The same scores for every class: the squares' mean brightness."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean((1, 2, 3))[:, None].repeat(1, 13)
