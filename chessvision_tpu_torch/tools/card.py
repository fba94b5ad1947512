"""The card a measurement ran on, and its published peaks.

Every line the measuring tools print with a time or a rate carries
``card_fields(device)``: the card's name and power limit as

    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

gives them (a card may be set below its rated power and then runs slower
under load), or ``"cpu"`` and ``None`` on the CPU.  ``peaks(name)`` gives
the rates a share of peak is taken against; a card missing from
``PEAKS`` raises with its name rather than borrow another card's."""

from __future__ import annotations

import subprocess
from typing import Any

import torch

# dense (no sparsity) bf16 tensor-core FLOP/s and device-memory bytes/s,
# from NVIDIA's H100 data sheet (SXM5 part, 700 W)
PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_per_s": 989.4e12, "bytes_per_s": 3.35e12},
}


def _watts(text: str) -> float | None:
    """'700.00 W' → 700.0; '[N/A]' → None."""
    try:
        return float(text.strip().split()[0])
    except (ValueError, IndexError):
        return None


def card_fields(device: str | torch.device) -> dict[str, Any]:
    """{"device": card name, "power_limit_w": watts} of ``device``'s card,
    read from nvidia-smi (the name from torch and no limit where nvidia-smi
    does not answer); {"device": "cpu", "power_limit_w": None} on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    if "," not in out:
        return {"device": torch.cuda.get_device_name(index), "power_limit_w": None}
    name, _, limit = out.splitlines()[0].rpartition(",")
    return {"device": name.strip(), "power_limit_w": _watts(limit)}


def peaks(name: str) -> dict[str, float]:
    """The published peaks of the card called ``name`` (``PEAKS``)."""
    try:
        return PEAKS[name]
    except KeyError:
        raise ValueError(
            f"no published peaks for card {name!r}: add its data sheet's dense bf16 FLOP/s and "
            "memory bytes/s to chessvision_tpu_torch/tools/card.py:PEAKS"
        ) from None
