"""Arbitrate-tail chunk sweep: boards/s of ``Engine.run_device`` on frames
already on the card at one batch, chunk and refine mode, the counterpart
of ``scripts/sweep_arbitrate_chunk.py``.

The arbitrate tail classifies each board twice (the nominal and the
grid-corrected warp) over chunks of ``--chunk`` boards, one chunk after
the other; the chunk bounds the tail's memory and sets how many boards
each launch covers.  One configuration a run, as the JAX script runs it
(``CVTPU_ARBITRATE_CHUNK`` sets the engine's default chunk):

    for c in 128 256 512 1024; do
      python -m chessvision_tpu_torch.tools.sweep_arbitrate_chunk --chunk $c; done
    python -m chessvision_tpu_torch.tools.sweep_arbitrate_chunk --refine off
    python -m chessvision_tpu_torch.tools.sweep_arbitrate_chunk --refine detect

The default batch is the JAX script's 1024.  A batch the card cannot hold
prints the out-of-memory error instead of the rates.

Frames: synthetic boards of seed 0 (32 distinct) tiled on the device.
Prints one JSON line: the batch's boards/s and ms, the first call's
seconds, the boards found and a digest of the FENs (equal across chunks),
or the error where the card ran out of memory, and the most memory the
process had allocated on the card (``peak_memory_gb``; null on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.tools import card
from chessvision_tpu_torch.tools.bench import assemble_fens, fens_digest
from chessvision_tpu_torch.utils import default_train_dtype, resolve_device


def run(engine: Engine, frames: torch.Tensor, iters: int) -> dict[str, Any]:
    """The record's measurements of ``engine.run_device(frames)``, with the
    boards found and the FENs' digest of its last call."""
    t0 = time.perf_counter()
    engine.run_device(frames)["found"].cpu()
    rec: dict[str, Any] = {"compile_plus_first_s": round(time.perf_counter() - t0, 2)}
    t0 = time.perf_counter()
    for _ in range(iters):
        out = engine.run_device(frames)
        out["found"].cpu()
    dt = time.perf_counter() - t0
    fens = assemble_fens(out, constants.SQUARE_NAMES_NORMAL)
    rec.update(
        boards_per_sec=round(len(frames) * iters / dt, 2),
        ms_per_batch=round(1000 * dt / iters, 2),
        boards_found=sum(1 for f in fens if f),
        fens_sha256=fens_digest(fens),
    )
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Arbitrate-chunk sweep of the PyTorch port (one JSON line)")
    ap.add_argument("--batch", type=int, default=1024, help="boards a batch")
    ap.add_argument("--chunk", type=int, default=128, help="arbitrate tail chunk")
    ap.add_argument("--refine", default="arbitrate", choices=["arbitrate", "detect", "off"])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision

    dev = resolve_device(args.device)
    cv = ChessVision(lazy_load=False, device=dev, dtype=default_train_dtype(dev))
    base = cv.engine
    engine = Engine(base._extractor, base._classifier, classifier_outputs_probabilities=base._cls_probs_flag,
                    refine_grid=args.refine, arbitrate_chunk=args.chunk, device=dev)
    rec: dict[str, Any] = {"batch": args.batch, "chunk": args.chunk, "refine": args.refine, "backend": dev.type,
                           **card.card_fields(dev)}
    uniq = torch.from_numpy(board_frames(0, min(args.batch, 32))[0]).to(dev)
    frames = uniq.repeat(-(-args.batch // len(uniq)), 1, 1, 1)[: args.batch]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        rec.update(run(engine, frames, args.iters))
    except torch.OutOfMemoryError as e:  # a batch the card cannot hold is a data point
        rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
