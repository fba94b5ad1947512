"""The card a run is on, and the published peaks its shares are taken
against: dense (no sparsity) bf16 tensor-core FLOP/s and device-memory
bytes/s from NVIDIA's H100 data sheet (SXM5 part, 700 W).  A card missing
from ``PEAKS`` has no share of peak: its readers return nothing."""

from __future__ import annotations

import subprocess

PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_per_s": 989.4e12, "bytes_per_s": 3.35e12},
}


def power_limit_w(index: int = 0) -> float | None:
    """The card's power limit in watts as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
