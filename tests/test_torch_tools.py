"""The port's data tools (``chessvision_tpu_torch/tools``) against the
scripts they port, ``scripts/error_analysis.py`` and
``scripts/mine_warped_squares.py``, on the CPU: both run on the stub
engines of tests/test_torch_engine.py over the same two 512² frames.

Bounds: the error reports are equal key for key (the port names its
device where the script names its platform); the mined ImageFolders hold
the same files, and their crops agree to one gray level (the two engines'
boards differ by up to ~0.03 gray before rounding, ROADMAP §3).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chessvision_tpu
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.tools import error_analysis, mine_warped_squares
from tests.test_torch_engine import STUB_QUAD, JaxStub, StubClassifier, StubExtractor, _quad_logits, _start_position_logits

REPO = Path(__file__).resolve().parent.parent
START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engines():
    seg, cls = _quad_logits(STUB_QUAD), _start_position_logits()
    port = SimpleNamespace(engine=Engine(StubExtractor(seg), StubClassifier(cls), device="cpu"))
    ref = SimpleNamespace(engine=JaxEngine(JaxStub(seg, "extractor"), {}, JaxStub(cls, "classifier"), {}))
    return port, ref


def _items():
    frames = board_frames(11, 2)[0]
    return [(frames[0], "a.JPG", START), (frames[1], "b.JPG", "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR")]


def test_error_analysis_matches_the_script(engines, tmp_path, monkeypatch) -> None:
    port, ref = engines
    got = error_analysis.analyze(port, _items(), chunk=2, platform="cpu")
    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: ref, raising=False)
    import chessvision_tpu.eval.evaluate as jeval

    monkeypatch.setattr(jeval, "get_test_generator", lambda *a, **k: iter(_items()))
    out = tmp_path / "report.json"
    monkeypatch.setattr(sys, "argv", ["error_analysis.py", "--platform", "cpu", "--chunk", "2", "--out", str(out)])
    _script("error_analysis").main()
    want = json.loads(out.read_text())
    assert json.loads(json.dumps(got)) == want
    assert got["total_errors"] == 4 and got["num_boards"] == 2
    error_analysis.print_summary(got)


def test_error_analysis_records_a_missed_board() -> None:
    """A board the engine does not find counts 64 errors and its mask's
    fragments are recorded (the port reads the whole 256² mask)."""
    logits = np.full((256, 256), -8.0, np.float32)
    logits[20:220, 20:220] = 8.0
    logits[60:180, 60:220] = -8.0  # a C shape: its hull over-covers it, no board
    cv = SimpleNamespace(engine=Engine(StubExtractor(logits), StubClassifier(_start_position_logits()), device="cpu"))
    report = error_analysis.analyze(cv, _items()[:1], chunk=1)
    assert report["extraction_failure"]["num_components"] == 1
    assert report["extraction_failure"]["top_areas"] == [200 * 200 - 120 * 160]
    assert report["boards_by_errors"] == [] and report["total_errors"] == 0


def test_mine_warped_squares_matches_the_script(engines, tmp_path, monkeypatch) -> None:
    port, ref = engines
    frames = np.stack([f for f, _, _ in _items()])
    ids = ["x/a.JPG", "x/b.JPG"]
    mined, found = mine_warped_squares.mine(port, frames, ids, min_conf=0.955, chunk=2)
    assert found == 2
    counts = mine_warped_squares.write_image_folder(mined, tmp_path / "port", max_per_class=20, seed=5)

    import chessvision_tpu.train.data as jdata

    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: ref, raising=False)
    monkeypatch.setattr(jdata, "load_board_extraction", lambda: SimpleNamespace(train_images=frames, train_ids=ids))
    monkeypatch.setattr(sys, "argv", ["mine_warped_squares.py", "--platform", "cpu", "--chunk", "2",
                                      "--max-per-class", "20", "--out", str(tmp_path / "jax")])
    _script("mine_warped_squares").main()
    import cv2

    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert sum(counts.values()) == len(files) and counts["f"] == 20 and counts["P"] == 16
    for rel in files:
        a = cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_GRAYSCALE).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_GRAYSCALE).astype(int)
        assert np.abs(a - b).max() <= 1, rel
    assert mine_warped_squares.dir_name("b") == "_b" and mine_warped_squares.dir_name("Q") == "Q"
