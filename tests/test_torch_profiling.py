"""The port's profiling utilities on the CPU: the keys the JAX package's
``profiling`` returns, the stage split of ``process_batch`` by its spans
and the interval arithmetic of ``span_self_ms``, ``device_busy`` and
``upload_overlap``."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from chessvision_tpu import profiling as jax_profiling
from chessvision_tpu_torch import profiling
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.synthetic import board_frames


@pytest.fixture(scope="module")
def cv_model() -> ChessVision:
    return ChessVision(device="cpu", dtype=torch.float32)


def test_time_fn_keys_and_calls() -> None:
    calls = []
    out = profiling.time_fn(lambda a, b: calls.append(a + b), 1, 2, iters=3, warmup=2)
    assert set(out) == {"p50_ms", "best_ms"} and 0 <= out["best_ms"] <= out["p50_ms"]
    assert calls == [3] * 5
    want = jax_profiling.time_fn(lambda a, b: np.float32(a + b), 1, 2, iters=1, warmup=1)
    assert set(out) == set(want)
    assert len(profiling.wall_ms(lambda: None, iters=4)) == 4


def test_profile_engine_stages_keys(cv_model) -> None:
    out = profiling.profile_engine_stages(cv_model, batch_size=2, iters=1)
    assert list(out) == ["resize", "unet", "quadrangle", "warp", "classify"]
    for stage in out.values():
        assert set(stage) == {"p50_ms", "best_ms"} and stage["best_ms"] > 0


def test_stage_breakdown_splits_the_host_side_and_restores(cv_model) -> None:
    """The host self time of each stage span of one call; nothing of the
    engine is patched."""
    from chessvision_tpu_torch import engine as engine_mod

    engine = cv_model.engine
    before = (engine_mod._copy_back, engine_mod.validate_labels_batch, engine._extractor)
    frames = board_frames(seed=2, n=1)[0]
    stages, total = profiling.stage_breakdown(engine, frames)
    assert set(stages) == {"upload", "front", "extractor", "quad", "warp", "gridfix", "arbitrate", "copy_back",
                           "device_wait", "mask", "validate", "fen", "other"}  # fmt: skip
    assert total > 0 and abs(sum(stages.values()) - total) < 1e-6
    assert all(v >= 0 for v in stages.values()), stages
    assert (engine_mod._copy_back, engine_mod.validate_labels_batch, engine._extractor) == before
    assert engine._on_device.__func__ is type(engine)._on_device


def _events(*spans, device=torch.autograd.DeviceType.CUDA):
    return [types.SimpleNamespace(name=n, device_type=device, time_range=types.SimpleNamespace(start=a, end=b))
            for n, a, b in spans]


def test_span_self_time_leaves_out_the_child_spans() -> None:
    cpu = torch.autograd.DeviceType.CPU
    prof = types.SimpleNamespace(events=lambda: _events(
        ("cv:copy_back", 0, 5000), ("cv:device_wait", 0, 3000), ("aten::copy_", 3000, 4000),
        ("cv:arbitrate", 6000, 7000), ("cv:arbitrate", 7000, 7500), ("bench:request", 0, 9000),
        device=cpu) + _events(("cv:mirror", 0, 9000)))  # fmt: skip
    assert profiling.span_self_ms(prof) == {"copy_back": 2.0, "device_wait": 3.0, "arbitrate": 1.5}


def test_device_busy_counts_two_overlapping_streams_once(monkeypatch) -> None:
    """A kernel on the compute stream and an upload on the copy stream that
    overlap for 0.5 ms: busy 2.0 ms, where summing each event's device time
    gives 2.5."""
    events = _events(("conv_kernel", 0, 1000), ("Memcpy HtoD (Pinned -> Device)", 500, 2000)) + _events(
        ("aten::conv2d", 0, 9000), device=torch.autograd.DeviceType.CPU)

    class Recorded:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

        def key_averages(self):
            return types.SimpleNamespace(table=lambda **kw: "table")

    monkeypatch.setattr(profiling, "_profiler", Recorded)
    busy, wall, table = profiling.device_busy(lambda: None)
    assert (busy, table) == (2.0, "table") and wall >= 0


def test_trace_writes_a_chrome_trace(tmp_path) -> None:
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("sum" in e.get("name", "") for e in events)
    assert profiling.upload_overlap(prof) == {"h2d_copies": 0.0, "h2d_ms": 0.0, "h2d_under_kernels_ms": 0.0, "kernels_ms": 0.0}
    busy, wall, table = profiling.device_busy(lambda: torch.ones(8).sum())
    assert busy == 0.0 and wall > 0 and isinstance(table, str)


def test_upload_overlap_interval_arithmetic() -> None:
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, start, end, device=cuda):
        return types.SimpleNamespace(name=name, device_type=device, time_range=types.SimpleNamespace(start=start, end=end))

    prof = types.SimpleNamespace(events=lambda: [
        ev("conv_kernel", 0, 1000), ev("bn_kernel", 500, 2000),  # one merged interval 0–2000
        ev("relu_kernel", 3000, 4000),
        ev("Memcpy HtoD (Pinned -> Device)", 1500, 3500),  # 500 + 500 under kernels
        ev("Memcpy HtoD (Pageable -> Device)", 5000, 6000),  # none
        ev("Memcpy DtoH (Device -> Pageable)", 0, 4000),  # not an upload
        ev("Memset (Device)", 0, 9000),  # neither
        ev("aten::conv2d", 0, 9000, device=torch.autograd.DeviceType.CPU),
    ])  # fmt: skip
    assert profiling.upload_overlap(prof) == {
        "h2d_copies": 2.0, "h2d_ms": 3.0, "h2d_under_kernels_ms": 1.0, "kernels_ms": 3.0,
    }  # fmt: skip
