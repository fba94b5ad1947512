"""End-to-end benchmark of the port: boards/s image→FEN on the card, the
counterpart of ``bench.py``.

    python bench_torch.py [--batch-size 128] [--iters 6] [--quick] [--device cpu]

Prints ONE JSON line with ``bench.py``'s keys where their meaning carries
over: ``metric`` "boards_per_sec_e2e", ``value`` (the best exact streamed
path), ``unit``, the four paths' boards/s and KB a board, B=1 p50 latency
full and ``lite``, the serialized yuv444 probe, the compute probe on frames
already on the card and its share of the card's bf16 peak
(``compute_mfu``, every convolution tap counted, padding included; the
taps inside the input alone, as XLA counts them, give
``pipeline_gflop_per_board_in_bounds``), the host-to-card upload rate before and after the
streams, the last batch's boards found and a digest of its FENs, and the
card's name and power limit.

Measured in ``bench.py``'s order, after every entry point has run once on
zeros made on the device (cuDNN's algorithm choice, lazy set-up):

1. B=1 p50 of ``process_batch``, full and ``lite`` alternating, 7 pairs;
2. four streamed paths through ``Engine.run_stream``, round-robin, each
   element a whole host-image→FEN pass (host packing, upload, device
   pipeline, probabilities back, validation and FEN strings):
   ``packed`` (448 KB a board, bit-identical to raw frames), ``yuv444``
   (416 KB, bit-exact reconstruction), ``yuv420`` (288 KB, approximate
   chroma: reported, never the headline) and ``raw_frame`` (768 KB);
3. one serialized yuv444 pass (pack, upload, compute in sequence), so that
   the streams' overlap shows;
4. ``Engine.run_device`` on frames already on the card at 8× the batch
   (1024 at the default 128), halved only when the card runs out of
   memory, as the JAX script does; ``compute_batch_size`` is the batch it
   measured at.

Frames: the 512² JPEGs of ``<data root>/test/initial/raw`` where present;
otherwise ``synthetic.board_frames(seed, 32)`` (chroma limited, so that the
yuv444 codec is exact on them as on photos), tiled to the batch.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Any

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.engine import (
    Engine,
    _fen_strings,
    pack_inputs,
    pack_inputs_yuv,
    pack_inputs_yuv444,
    validate_labels_batch,
)
from chessvision_tpu_torch.profiling import _sync
from chessvision_tpu_torch.synthetic import board_frames, limit_chroma
from chessvision_tpu_torch.tools import card, flops
from chessvision_tpu_torch.utils import default_train_dtype, resolve_device

LATENCY_PAIRS = 7
# exact paths: their FENs equal the raw frames' (yuv420's chroma is approximate)
EXACT_PATHS = ("packed", "yuv444", "raw_frame")


def assemble_fens(out: dict[str, torch.Tensor], square_names: list[str]) -> list[str]:
    """Host half of image→FEN (timed): validation and FEN strings; "" where
    no board was found."""
    probs = out["probabilities"].cpu().numpy()
    found = out["found"].cpu().numpy()
    validated, _ = validate_labels_batch(probs, square_names)
    return _fen_strings(probs, validated, found, square_names)[0]


def fens_digest(fens: list[str]) -> str:
    """sha256 of the FENs one a line ("" for no board): equal digests, equal
    found flags and FENs."""
    return hashlib.sha256("\n".join(fens).encode()).hexdigest()


def bench_frames(bsz: int, seed: int) -> tuple[np.ndarray, str]:
    """(bsz, 512, 512, 3) uint8 frames and where they came from: the test
    photos tiled, else seeded synthetic boards tiled."""
    test_dir = constants.data_root() / "test" / "initial" / "raw"
    images = []
    if test_dir.exists():
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            for p in sorted(test_dir.glob("*.JPG")):
                im = cv2.imread(str(p))
                if im is not None and im.shape == (512, 512, 3):
                    images.append(im)
    if images:
        uniq, source = np.stack(images), f"{len(images)} photos of {test_dir}"
    else:
        uniq, source = limit_chroma(board_frames(seed, min(bsz, 32))[0]), f"synthetic, seed {seed}"
    return np.concatenate([uniq] * -(-bsz // len(uniq)))[:bsz], source


def link_probe(batch: np.ndarray, device: torch.device) -> float:
    """MB/s of a pageable upload of an eighth of the batch."""
    probe = batch[: max(1, len(batch) // 8)]
    t0 = time.perf_counter()
    torch.tensor(probe, device=device)
    _sync(device)
    return probe.nbytes / 1e6 / (time.perf_counter() - t0)


def warm_up(engine: Engine, batch: np.ndarray) -> None:
    """Every entry point once on zeros made on the device, at the shapes
    the measurement gives it: no host-to-device bytes."""
    dev, b = engine.device, len(batch)

    def zeros(*arrays: np.ndarray, n: int = b) -> list[torch.Tensor]:
        return [torch.zeros((n, *a.shape[1:]), dtype=torch.uint8, device=dev) for a in arrays]

    one = batch[:1]
    engine.run_packed(*zeros(*pack_inputs(one)))
    engine.run_yuv(*zeros(*pack_inputs_yuv(one)))
    engine.run_yuv444(*zeros(*pack_inputs_yuv444(one)))
    engine.run_device(*zeros(one))
    engine.run_device(*zeros(one, n=1))
    engine.process_batch(*zeros(one, n=1), lite=True)
    _sync(dev)


def compute_rate(engine: Engine, frames: torch.Tensor, cbsz: int, iters: int) -> float:
    """boards/s of ``run_device`` on ``frames`` tiled to ``cbsz`` on the device
    (the found flags back to the host end each call)."""
    dev_batch = frames.repeat(-(-cbsz // len(frames)), 1, 1, 1)[:cbsz]
    engine.run_device(dev_batch)["found"].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.run_device(dev_batch)["found"].cpu()
    return cbsz * iters / (time.perf_counter() - t0)


def compute_probe(engine: Engine, batch: np.ndarray, cbsz: int, iters: int) -> tuple[float | None, int, str | None]:
    """(boards/s, batch it ran at, error) of ``compute_rate`` at ``cbsz``,
    halved while the card runs out of memory, down to the e2e batch."""
    frames = torch.from_numpy(batch).to(engine.device)
    while True:
        try:
            return compute_rate(engine, frames, cbsz, iters), cbsz, None
        except torch.OutOfMemoryError as e:
            err = f"{type(e).__name__}: {str(e)[:200]}"
        torch.cuda.empty_cache()
        if cbsz <= len(batch):
            print(f"compute phase failed: {err}", file=sys.stderr)
            return None, cbsz, err
        cbsz //= 2
        print(f"compute batch out of memory, retrying at {cbsz}", file=sys.stderr)


def run(engine: Engine, batch: np.ndarray, iters: int, compute_batch: int) -> tuple[dict[str, Any], list[str]]:
    """The measurements on ``batch`` (B, H, W, 3) uint8: the JSON record
    without the card's fields, and the last streamed batch's FENs."""
    bsz = len(batch)
    dev = engine.device
    square_names = constants.SQUARE_NAMES_NORMAL
    warm_up(engine, batch)
    link_before = link_probe(batch, dev)

    single = batch[:1]
    engine.process_batch(single)
    engine.process_batch(single, lite=True)
    lat_full, lat_lite = [], []
    for _ in range(LATENCY_PAIRS):  # alternating, so drift hits both alike
        t = time.perf_counter()
        engine.process_batch(single)
        lat_full.append(time.perf_counter() - t)
        t = time.perf_counter()
        engine.process_batch(single, lite=True)
        lat_lite.append(time.perf_counter() - t)

    paths = {
        "packed": ("packed", lambda: pack_inputs(batch)),
        "yuv444": ("yuv444", lambda: pack_inputs_yuv444(batch)),
        "yuv420": ("yuv", lambda: pack_inputs_yuv(batch)),
        "raw_frame": ("raw", lambda: batch),
    }
    kb_per_board = {
        "packed": sum(a.nbytes for a in pack_inputs(single)) / 1024,
        "yuv444": sum(a.nbytes for a in pack_inputs_yuv444(single)) / 1024,
        "yuv420": sum(a.nbytes for a in pack_inputs_yuv(single)) / 1024,
        "raw_frame": single.nbytes / 1024,
    }
    fens: list[str] = []

    def stream_once(kind: str, pack: Any, n_batches: int) -> float:
        nonlocal fens
        gen = (pack() for _ in range(n_batches))
        t0 = time.perf_counter()
        for out in engine.run_stream(gen, kind=kind):
            fens = assemble_fens(out, square_names)
        return time.perf_counter() - t0

    cycles = 2 if iters >= 2 else 1
    stream_len = max(1, iters // cycles)
    rates: dict[str, list[float]] = {k: [] for k in paths}
    for _ in range(cycles):  # round-robin: every path sees the same drift
        for name, (kind, pack) in paths.items():
            rates[name].append(stream_len * bsz / stream_once(kind, pack, stream_len))
    t0 = time.perf_counter()
    assemble_fens(engine.run_yuv444(*pack_inputs_yuv444(batch)), square_names)
    serialized_yuv444 = bsz / (time.perf_counter() - t0)
    link_after = link_probe(batch, dev)
    boards_per_sec = {k: float(np.median(v)) for k, v in rates.items()}

    compute, cbsz, compute_err = compute_probe(engine, batch, compute_batch, iters)
    best_e2e = max(boards_per_sec[k] for k in EXACT_PATHS)
    record: dict[str, Any] = {
        "metric": "boards_per_sec_e2e",
        "value": round(best_e2e, 2),
        "unit": "boards/s",
        "paths_boards_per_sec": {k: round(v, 2) for k, v in boards_per_sec.items()},
        "paths_kb_per_board": {k: round(v, 1) for k, v in kb_per_board.items()},
        "e2e_mode": "streamed",
        "stream_batches_per_cycle": stream_len,
        "serialized_yuv444_boards_per_sec": round(serialized_yuv444, 2),
        "compute_boards_per_sec": round(compute, 2) if compute is not None else None,
        "compute_batch_size_attempted": compute_batch,
        "compute_batch_size": cbsz if compute is not None else None,
        "link_mb_per_sec_before_e2e": round(link_before, 1),
        "link_mb_per_sec_after_e2e": round(link_after, 1),
        "p50_latency_ms": round(float(np.median(lat_full)) * 1000, 2),
        "p50_latency_lite_ms": round(float(np.median(lat_lite)) * 1000, 2),
        "batch_size": bsz,
        "boards_found_last_batch": sum(1 for f in fens if f),
        "fens_sha256": fens_digest(fens),
    }
    if compute_err:
        record["compute_error"] = compute_err
    return record, fens


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="End-to-end boards/s of the PyTorch port (one JSON line)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--quick", action="store_true", help="tiny config for smoke runs (B=4, iters 2)")
    ap.add_argument("--extractor", default=None, help="extractor model id (default unet)")
    ap.add_argument("--classifier", default=None, help="classifier model id (default resnet18)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic frames")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_size, args.iters = 4, 2

    from chessvision_tpu_torch.core import ChessVision

    dev = resolve_device(args.device)
    fields = card.card_fields(dev)
    peak = card.peaks(fields["device"])["bf16_flop_per_s"] if dev.type == "cuda" else None
    cv = ChessVision(board_extractor_model_id=args.extractor, classifier_model_id=args.classifier,
                     lazy_load=False, device=dev, dtype=default_train_dtype(dev))
    batch, source = bench_frames(args.batch_size, args.seed)
    record, _ = run(cv.engine, batch, args.iters, args.batch_size if args.quick else 8 * args.batch_size)
    flop = flops.pipeline_flops_per_board(cv.engine, batch[:1])
    compute = record["compute_boards_per_sec"]
    record["pipeline_gflop_per_board"] = round(flop / 1e9, 3)
    record["pipeline_gflop_per_board_in_bounds"] = round(
        flops.pipeline_flops_per_board(cv.engine, batch[:1], in_bounds=True) / 1e9, 3)
    record["compute_mfu"] = round(flop * compute / peak, 4) if peak and compute else None
    record.update(frames=source, backend=dev.type, **fields)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
