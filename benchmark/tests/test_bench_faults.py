"""A run whose timed path is broken comes out not correct; the control,
the reference in float8 put in the program's place, fails the check.

Each fault is planted in the port underneath a whole run of the harness
(``session.run``) on the CPU at a size a test holds, everything but the
look for a card.  The cells run on one card, so there is no exchange
between cards to leave out."""

import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import session, spec

torch.set_num_threads(4)


def _run(cell_name, seconds=0.2, inputs=None, retain=None):
    cell = spec.load_cell(cell_name)
    calibrate.shrink(cell)
    f = cell.traffic["frames"]
    f["count"] = f["batch"] * (inputs or f["count"] // f["batch"])
    cell.traffic["retain"] = retain or cell.traffic["retain"]
    result, lines = session.run(cell, 2**31 + 99, seconds, False, torch.device("cpu"), time.perf_counter())
    return result


def _half_batch(engine_mod, monkeypatch):
    """Only the first half of each batch is computed; the rest get the
    mean over it."""
    real = engine_mod._pipeline_core

    def half(extractor, classifier, flag, comp, gray, *a, **k):
        b = comp.shape[0]
        out = real(extractor, classifier, flag, comp[: max(1, b // 2)], gray[: max(1, b // 2)], *a, **k)
        fill = {}
        for key, v in out.items():
            rest = v.float().mean(0, keepdim=True).to(v.dtype) if v.is_floating_point() else v[:1]
            fill[key] = torch.cat([v, rest.expand(b - v.shape[0], *v.shape[1:])])
        return fill

    monkeypatch.setattr(engine_mod, "_pipeline_core", half)


def _stale(engine_mod, monkeypatch):
    """Every call after the first returns the first call's outputs."""
    real, first = engine_mod._pipeline_core, []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    monkeypatch.setattr(engine_mod, "_pipeline_core", stale)


def _altered_answer(engine_mod, monkeypatch):
    """The first FEN of each batch comes out changed where it is made."""
    real = engine_mod._fen_strings

    def altered(*a, **k):
        fens, orig = real(*a, **k)
        fens = ["8/8/8/8/8/8/8/8" if fens[0] != "8/8/8/8/8/8/8/8" else "K7/8/8/8/8/8/8/8"] + fens[1:]
        return fens, orig

    monkeypatch.setattr(engine_mod, "_fen_strings", altered)


FAULTS = {"half_batch": _half_batch, "stale": _stale, "altered_answer": _altered_answer}


def test_a_sound_run_is_correct():
    assert _run("unet32.batch512")["correct"]


@pytest.mark.parametrize(
    "cell, fault",
    [("unet32.batch512", f) for f in FAULTS] + [("unet32.photo12mp", "stale"), ("unet32.photo12mp", "altered_answer"),
                                                ("unet32.stream512", "altered_answer"), ("unet32.stream512", "stale"),
                                                ("unet64.batch512", "half_batch")],
)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from chessvision_tpu_torch import engine as engine_mod

    FAULTS[fault](engine_mod, monkeypatch)
    # a stale answer shows on every input but the first call's: four
    # inputs, eight requests compared, so that some other input is among
    # them but once in 4**8 windows
    result = _run(cell, 4.0, 4, 8) if fault == "stale" else _run(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["unet32.batch512", "unet64.batch512", "unet32.photo12mp", "unet32.stream512"])
def test_the_control_fails_the_check(cell):
    """The float8 control, put in the program's place, comes out not
    correct under the cell's committed limits, where the float32 program
    passes (the readings the limits were set from are in PERF.md; these
    are at a CPU's size)."""
    c = spec.load_cell(cell)
    calibrate.shrink(c)
    readings = calibrate.control_readings(c, 17, torch.device("cpu"))
    assert readings["correct"] is False and readings["over_limit"], readings
