"""The port's profiling utilities on the CPU: the keys the JAX package's
``profiling`` returns, the stage split of ``process_batch`` and the
interval arithmetic of ``upload_overlap``."""

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
    from chessvision_tpu_torch import engine as engine_mod

    engine = cv_model.engine
    before = (engine_mod._copy_back, engine_mod.validate_labels_batch, engine._extractor)
    frames = board_frames(seed=2, n=1)[0]
    stages, total = profiling.stage_breakdown(engine, frames, iters=1)
    assert {"upload", "_copy_back", "_binary_mask", "validate_labels_batch", "_fen_strings"} <= set(stages)
    assert {"preprocess_images", "unet", "find_quadrangle_batch", "warp_perspective", "detect_grid",
            "_arbitrate_chunk", "other"} <= set(stages)  # fmt: skip
    assert total > 0 and abs(sum(stages.values()) - total) < 1e-6
    assert (engine_mod._copy_back, engine_mod.validate_labels_batch, engine._extractor) == before
    assert engine._on_device.__func__ is type(engine)._on_device


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
