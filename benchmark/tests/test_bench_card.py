"""On the card: a short run of each cell is correct, and the float8
control fails the check at the cell's own size.  Skips without a CUDA
device (``python -m pytest -m cuda benchmark/tests`` on the card)."""

import json
import time

import pytest

from benchmark import calibrate
from benchmark.harness import session, spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    c = spec.load_cell(cell)
    result, lines = session.run(c, 2**31 + 5, 2.0, False, card, time.perf_counter())
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    readings = calibrate.control_readings(spec.load_cell(cell), 2**31 + 9, card)
    assert readings["correct"] is False and readings["over_limit"], readings
