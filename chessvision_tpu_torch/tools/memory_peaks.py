"""Peak device memory of ``Engine.run_device`` by stage and batch.

For each ``--batch``: frames already on the card (synthetic boards of seed
0, 32 distinct, tiled), the allocator's peak reset, then one
``run_device`` call.  The peak is read twice: when the extractor (the
UNet) returns, through a forward hook (the allocator's count is kept on
the host, so no synchronize is needed), and after the call, which adds
the warp, the grid refinement and the arbitrate tail.  A batch the card
cannot hold is recorded with its error and the peak it reached.

    python -m chessvision_tpu_torch.tools.memory_peaks [--batch 128 512 1024]

Prints one JSON line a batch, with the engine's arbitrate chunk and the
card's name and power limit.  The card only: peak device memory has no
CPU counterpart.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import torch

from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.tools import card


def peaks(engine: Engine, frames: torch.Tensor, batch: int) -> tuple[dict[str, Any], dict[str, torch.Tensor] | None]:
    """(record, run_device's outputs or None on out-of-memory) of one
    ``run_device`` call on ``frames`` tiled to ``batch``: GB allocated
    before it, at the peak through the UNet and at the peak of the call."""
    dev = frames.device
    x = frames.repeat(-(-batch // len(frames)), 1, 1, 1)[:batch]
    marks: list[int] = []
    hook = engine._extractor.register_forward_hook(lambda *_: marks.append(torch.cuda.max_memory_allocated(dev)))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rec: dict[str, Any] = {"batch": batch, "resident_gb": torch.cuda.memory_allocated(dev) / 1e9}
    out = None
    try:
        out = engine.run_device(x)
        torch.cuda.synchronize(dev)
    except torch.OutOfMemoryError as e:  # a batch the card cannot hold is a data point
        rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    finally:
        hook.remove()
    rec["unet_peak_gb"] = marks[0] / 1e9 if marks else None
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return rec, out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Peak device memory of run_device by stage (one JSON line a batch)")
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 512, 1024])
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    engine = ChessVision(lazy_load=False, device=dev).engine
    frames = torch.from_numpy(board_frames(0, 32)[0]).to(dev)
    engine.run_device(frames[:8])  # cuDNN's algorithm choice and lazy set-up, off the record
    for batch in args.batch:
        rec, _ = peaks(engine, frames, batch)
        print(json.dumps({**rec, "chunk": engine._arbitrate_chunk, **card.card_fields(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
