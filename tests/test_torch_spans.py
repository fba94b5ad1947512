"""The port's stage spans (``profiling.span``) on the CPU: each entry point
records every stage span the expected number of times, inside its parent;
every span is a plain host op that nothing mirrors onto the device; the
outputs do not depend on whether a profiler records; a stream closed
mid-way leaves no span open; and nothing in the port makes spans another
way."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch import profiling
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.synthetic import board_frames

PORT = Path(engine_mod.__file__).resolve().parent

# the stages of one pipeline call: ``_on_device`` runs twice (the frames,
# then the comp and gray that are already on the device)
PIPELINE = {"upload": 2, "front": 1, "extractor": 1, "quad": 1, "warp": 1, "gridfix": 1}
HOST = {"copy_back": 1, "device_wait": 1, "validate": 1, "fen": 1}


@pytest.fixture(scope="module")
def cv_model() -> ChessVision:
    return ChessVision(device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def engine(cv_model) -> Engine:
    """The facade's models in an engine that chunks the arbitrate tail one
    board at a time."""
    ex, _ = cv_model.board_extractor
    cl, spec = cv_model.classifier
    return Engine(ex, cl, classifier_outputs_probabilities=spec.outputs_probabilities, refine_grid="arbitrate",
                  arbitrate_chunk=1, device="cpu")


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    return board_frames(seed=1, n=2)[0]


def _spans(prof) -> list[tuple[float, float, str]]:
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.name.startswith(profiling.SPAN_PREFIX)]


def _parent(s: tuple[float, float, str], spans: list[tuple[float, float, str]]) -> str | None:
    """The name of the shortest other span that holds ``s``, prefix removed."""
    holders = [o for o in spans if o is not s and o[0] <= s[0] and s[1] <= o[1] and o[1] - o[0] > s[1] - s[0]]
    return min(holders, key=lambda o: o[1] - o[0])[2][len(profiling.SPAN_PREFIX):] if holders else None


def _stream_consumer(engine: Engine, batches: list[np.ndarray]) -> list[list[str]]:
    """What the stream's callers do with each batch: the probabilities back,
    validated, as FENs."""
    names = engine_mod.constants.SQUARE_NAMES_NORMAL
    fens = []
    for out in engine.run_stream(batches, kind="raw"):
        host = engine_mod._copy_back(out, ("probabilities", "found"))
        validated, _ = engine_mod.validate_labels_batch(host["probabilities"], names)
        fens.append(engine_mod._fen_strings(host["probabilities"], validated, host["found"], names)[0])
    return fens


@pytest.fixture(scope="module")
def recorded(cv_model, engine, frames, tmp_path_factory) -> dict:
    """One profiled call of each entry point: (spans, outputs); the batch's
    profile also written as a Chrome trace."""
    runs = {}
    out_dir = tmp_path_factory.mktemp("trace")
    with profiling.trace(out_dir) as prof:
        result = engine.process_batch(frames)
    runs["process_batch"] = (prof, result)
    runs["chrome"] = json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    with profiling.trace(tmp_path_factory.mktemp("trace")) as prof:
        result = cv_model.process_image(frames[0])
    runs["process_image"] = (prof, result)
    with profiling.trace(tmp_path_factory.mktemp("trace")) as prof:
        result = _stream_consumer(engine, [frames[:1], frames[1:]])
    runs["run_stream"] = (prof, result)
    return runs


# (expected count of each span, expected parent of each span where it has one)
EXPECTED = {
    "process_batch": ({**PIPELINE, "arbitrate": 2, **HOST, "mask": 1}, {"device_wait": "copy_back"}),
    "process_image": ({**PIPELINE, "arbitrate": 1, **HOST, "mask": 1, "facade": 1}, {"device_wait": "copy_back"}),
    "run_stream": (
        {**{k: 2 * n for k, n in PIPELINE.items()}, "arbitrate": 2, **{k: 2 * n for k, n in HOST.items()},
         "stream.stage": 2, "stream.caller": 2},
        {"device_wait": "copy_back", "copy_back": "stream.caller", "validate": "stream.caller",
         "fen": "stream.caller"},
    ),
}


@pytest.mark.parametrize("entry", sorted(EXPECTED))
def test_each_entry_point_records_its_stage_spans_inside_their_parents(recorded, entry) -> None:
    counts, parents = EXPECTED[entry]
    spans = _spans(recorded[entry][0])
    assert Counter(name[len(profiling.SPAN_PREFIX):] for _, _, name in spans) == counts
    for s in spans:
        assert _parent(s, spans) == parents.get(s[2][len(profiling.SPAN_PREFIX):]), s
    assert len(spans) / (2 if entry == "run_stream" else 1) <= 20  # a request's spans


def test_spans_are_host_ops_that_nothing_mirrors_onto_the_device(recorded) -> None:
    for entry in EXPECTED:
        for e in recorded[entry][0].events():
            if e.name.startswith(profiling.SPAN_PREFIX):
                assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation, e.name
                assert "memcpy" not in e.name.lower() and "memset" not in e.name.lower()
    written = [e for e in recorded["chrome"] if e.get("name", "").startswith(profiling.SPAN_PREFIX)]
    assert len(written) == len(_spans(recorded["process_batch"][0]))
    assert {e["cat"] for e in written} == {"cpu_op"}


def test_outputs_do_not_depend_on_a_profiler(recorded, engine, frames) -> None:
    traced = recorded["process_batch"][1]
    plain = engine.process_batch(frames)
    for field in ("logits", "binary_mask", "quadrangle", "board_found", "board_image", "probabilities"):
        np.testing.assert_array_equal(getattr(plain, field), getattr(traced, field), err_msg=field)
    assert (plain.fens, plain.original_fens, plain.validation_fixes) == (
        traced.fens, traced.original_fens, traced.validation_fixes)
    assert _stream_consumer(engine, [frames[:1], frames[1:]]) == recorded["run_stream"][1]


def test_a_stream_closed_midway_leaves_no_caller_span_open(engine, frames, tmp_path) -> None:
    with profiling.trace(tmp_path) as prof:
        stream = engine.run_stream([frames[:1], frames[1:], frames[:1]], kind="raw")
        next(stream)
        stream.close()
        with profiling.span("after_close"):
            pass
    spans = _spans(prof)
    callers = [s for s in spans if s[2] == "cv:stream.caller"]
    (mark,) = [s for s in spans if s[2] == "cv:after_close"]
    assert len(callers) == 1 and callers[0][0] < callers[0][1] <= mark[0]


def test_the_port_makes_spans_only_through_profiling() -> None:
    """``torch.profiler.record_function`` costs ten microseconds a span and
    its annotations are mirrored onto the device's timeline; the port's
    spans are ``profiling.span``."""
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "profiling.py" and path.parent == PORT:
            continue
        text = path.read_text()
        assert "record_function" not in text and "_RecordFunctionFast" not in text, path
