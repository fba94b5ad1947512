"""The port's end-to-end benchmark (``bench_torch.py``,
``chessvision_tpu_torch/tools/bench.py``) on the CPU.

- ``bench.run`` (what ``main`` calls) at B=2 on an engine with the stub
  models of tests/test_torch_engine.py and 256² frames (a CPU
  ``process_batch`` costs ~0.13 s a 512² board on one thread): every
  measured key, and the last streamed batch's FENs and found flags equal
  ``process_batch``'s on the same frames exactly;
- ``main --quick --device cpu`` with the measurement stood in for: one
  JSON line with bench.py's keys, ``backend`` "cpu", the CPU's card
  fields, B=4, iters 2, the compute probe at the e2e batch;
- the compute probe halves its batch on out-of-memory only;
- ``sweep_arbitrate_chunk --batch 2 --chunk 1 --device cpu`` gives the
  found flags and FENs of chunk 512 (the same engine, chunked);
- the pipeline's in-bounds FLOP count drops exactly the padding taps of
  its models' convolutions (one UNet, two ResNet18 passes);
- ``mfu_accounting``'s table on given times (the CPU has no peak), and on
  the CPU every time must be given;
- importing ``bench_torch`` loads no JAX module.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.tools import bench, flops, mfu_accounting, sweep_arbitrate_chunk
from test_torch_engine import STUB_QUAD, StubClassifier, StubExtractor, _quad_logits, _start_position_logits

REPO = Path(__file__).resolve().parent.parent
BENCH_KEYS = {
    "metric", "value", "unit", "paths_boards_per_sec", "paths_kb_per_board", "e2e_mode", "stream_batches_per_cycle",
    "serialized_yuv444_boards_per_sec", "compute_boards_per_sec", "compute_batch_size_attempted",
    "compute_batch_size", "link_mb_per_sec_before_e2e", "link_mb_per_sec_after_e2e", "p50_latency_ms",
    "p50_latency_lite_ms", "batch_size", "boards_found_last_batch", "fens_sha256",
}
MAIN_KEYS = BENCH_KEYS | {"compute_mfu", "pipeline_gflop_per_board", "pipeline_gflop_per_board_in_bounds", "frames",
                          "backend", "device", "power_limit_w"}


def test_bench_run_streams_the_fens_of_process_batch(monkeypatch) -> None:
    monkeypatch.setattr(bench, "LATENCY_PAIRS", 1)
    engine = Engine(StubExtractor(_quad_logits(STUB_QUAD)), StubClassifier(_start_position_logits()), device="cpu")
    frames = board_frames(3, 2, size=256)[0]
    rec, fens = bench.run(engine, frames, iters=1, compute_batch=2)
    assert set(rec) == BENCH_KEYS
    want = engine.process_batch(frames)
    assert fens == want.fens and [bool(f) for f in fens] == want.board_found.tolist()
    assert rec["fens_sha256"] == bench.fens_digest(want.fens)
    assert rec["boards_found_last_batch"] == int(want.board_found.sum()) == 2
    paths = rec["paths_boards_per_sec"]
    assert set(paths) == {"packed", "yuv444", "yuv420", "raw_frame"} and all(v > 0 for v in paths.values())
    # the headline is the best exact path: yuv420 never sets it
    assert rec["value"] == max(paths[k] for k in bench.EXACT_PATHS)
    assert rec["paths_kb_per_board"] == {"packed": 256.0, "yuv444": 224.0, "yuv420": 96.0, "raw_frame": 192.0}
    assert rec["compute_batch_size"] == rec["compute_batch_size_attempted"] == 2 and rec["compute_boards_per_sec"] > 0
    assert rec["batch_size"] == 2 and rec["stream_batches_per_cycle"] == 1 and rec["e2e_mode"] == "streamed"


def test_main_quick_on_the_cpu_prints_one_line(monkeypatch, capsys) -> None:
    seen = {}

    def measured(engine, batch, iters, compute_batch):
        seen.update(device=engine.device, shape=batch.shape, iters=iters, compute_batch=compute_batch)
        rec = {k: 1.0 for k in BENCH_KEYS}
        rec["compute_boards_per_sec"] = 3.0
        return rec, ["x"] * len(batch)

    monkeypatch.setattr(bench, "run", measured)
    monkeypatch.setattr(flops, "pipeline_flops_per_board", lambda engine, frame, n=4, in_bounds=False:
                        52e9 if in_bounds else 61e9)
    assert bench.main(["--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == MAIN_KEYS
    assert rec["backend"] == "cpu" and rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["compute_mfu"] is None and rec["pipeline_gflop_per_board"] == 61.0  # no card, no peak
    assert rec["pipeline_gflop_per_board_in_bounds"] == 52.0
    assert rec["frames"] == "synthetic, seed 0"
    assert seen == {"device": torch.device("cpu"), "shape": (4, 512, 512, 3), "iters": 2, "compute_batch": 4}


@pytest.mark.parametrize("fits,want", [(2, (1.0, 2, None)), (0, (None, 2, "OutOfMemoryError"))])
def test_compute_probe_halves_only_on_out_of_memory(monkeypatch, fits, want) -> None:
    tried = []

    def rate(engine, frames, cbsz, iters):
        tried.append(cbsz)
        if cbsz > fits:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 1.0

    monkeypatch.setattr(bench, "compute_rate", rate)
    engine = type("E", (), {"device": torch.device("cpu")})()
    got = bench.compute_probe(engine, np.zeros((2, 4, 4, 3), np.uint8), 8, 1)
    assert tried == [8, 4, 2]
    assert got[:2] == want[:2] and (got[2] or "").startswith(want[2] or "")
    monkeypatch.setattr(bench, "compute_rate", lambda *a: (_ for _ in ()).throw(ValueError("not memory")))
    with pytest.raises(ValueError):
        bench.compute_probe(engine, np.zeros((2, 4, 4, 3), np.uint8), 8, 1)


def test_sweep_chunk_one_gives_chunk_512s_fens(capsys) -> None:
    recs = []
    for chunk in ("1", "512"):
        argv = ["--batch", "2", "--chunk", chunk, "--device", "cpu", "--iters", "1"]
        assert sweep_arbitrate_chunk.main(argv) == 0
        recs.append(json.loads(capsys.readouterr().out))
    assert recs[0]["boards_found"] == recs[1]["boards_found"] > 0
    assert recs[0]["fens_sha256"] == recs[1]["fens_sha256"]
    assert recs[0]["backend"] == "cpu" and "error" not in recs[0]


def test_mfu_accounting_table_on_given_times(monkeypatch, capsys) -> None:
    monkeypatch.setattr(flops, "pipeline_flops_per_board", lambda engine, frame, n=4, in_bounds=False: 61e9)
    with pytest.raises(ValueError, match="give every time"):
        mfu_accounting.main(["--device", "cpu", "--unet-step-ms", "80"])
    argv = ["--device", "cpu", "--unet-step-ms", "80", "--cls-step-ms", "40", "--compute-boards-per-sec", "1000",
            "--warp-ms-128", "0.25"]
    assert mfu_accounting.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["backend"] == "cpu" and rec["power_limit_w"] is None and rec["xla_gflop"] == mfu_accounting.XLA_GFLOP
    unet, cls, pipe, warp = rec["rows"]
    assert unet["gflop"] == pytest.approx(2314.047848448) and cls["gflop"] == pytest.approx(215.899439104)
    assert unet["tflop_per_s"] == pytest.approx(2314.047848448 / 80) and unet["peak_share"] is None
    assert pipe["gflop"] == 61.0 and pipe["ms"] == pytest.approx(1.0) and warp["ms"] == 0.25
    assert rec["forward_gflop"]["resnet18_fwd_64_squares"]["all_taps"] == pytest.approx(18.128633856)
    assert any(line.startswith("UNet train step (B=32)") for line in out)


def test_pipeline_in_bounds_count_drops_the_models_padding_taps() -> None:
    """The pipeline's count less its in-bounds count is the padding taps of
    one UNet forward on the 256² frame and two ResNet18 passes over the
    board's 64 squares, each counted from the layers' shapes."""
    from chessvision_tpu_torch.core import ChessVision

    engine = ChessVision(device="cpu", dtype=torch.float32, lazy_load=False).engine
    frame = board_frames(0, 1)[0]
    every = flops.pipeline_flops_per_board(engine, frame, n=1)
    inside = flops.pipeline_flops_per_board(engine, frame, n=1, in_bounds=True)

    def padding(model, shape) -> float:
        meta, x = copy.deepcopy(model).to("meta"), torch.zeros(shape, device="meta")
        return flops.conv_flops(meta, x) - flops.conv_flops(meta, x, in_bounds=True)

    unet, squares = padding(engine._extractor, (1, 256, 256, 3)), padding(engine._classifier, (64, 64, 64, 1))
    assert squares > 0 and unet > 0
    assert every - inside == pytest.approx(unet + 2 * squares, rel=1e-9)
    assert every == flops.pipeline_flops_per_board(engine, frame, n=1)  # the hooks are gone


def test_importing_bench_torch_loads_no_jax() -> None:
    code = (
        "import sys, bench_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'chessvision_tpu')]\n"
        "print('bench' if 'chessvision_tpu_torch.tools.bench' in sys.modules else 'missing', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0 and out.stdout.split()[0] == "bench", out.stdout + out.stderr
