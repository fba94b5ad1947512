"""The port's four test-set tools (``chessvision_tpu_torch/tools``) against
the scripts they port, on the CPU: ``make_fen_goldens``, ``drift_gate``
(against ``scripts/tpu_drift_gate.py``), ``debug_gridfix`` and
``exp_gridfix_quad``.

- the goldens maker and the gate run on a recording stand-in engine whose
  FENs are read from each frame's pixels, so that the shape grouping,
  the chunks of 8 and the padded tails are held batch for batch; the
  scripts' output files are monkeypatched into ``tmp_path`` (the committed
  goldens are never written) and ``jax.default_backend`` reads "tpu", so
  that the TPU gate's logic runs here;
- the two grid-refinement tools run both packages' engines with the stub
  extractor of tests/test_torch_engine.py and a classifier whose
  probabilities follow each square's mean shade, on three seeded frames
  at 256² and 320² written as a test root.

Bounds: the goldens, the gate's summaries and failure strings, found
flags, FENs, chosen sides and every count equal; ``debug_gridfix``'s
confidences and gaps within 1e-5 and its corrections within 1e-3 px,
``exp_gridfix_quad``'s confidences within 1e-5 (the two engines' boards
differ by up to ~0.03 gray before rounding, ROADMAP §3).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import chessvision_tpu
import chessvision_tpu.eval.evaluate as jeval
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu_torch import core
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.eval import evaluate as port_eval
from chessvision_tpu_torch.synthetic import write_test_root
from chessvision_tpu_torch.tools import debug_gridfix, drift_gate, exp_gridfix_quad, make_fen_goldens
from chip_smoke import moved_fen
from tests.test_torch_engine import STUB_QUAD, JaxStub, StubExtractor, _quad_logits
from tests.test_torch_tools import _script

REPO = Path(__file__).resolve().parent.parent
FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR",
    "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR",
    "8/8/4k3/8/8/4K3/8/8",
]


# -- the goldens maker and the gate on a stand-in engine -------------------------------


class ReadingEngine:
    """``process_batch`` records each batch and reads a board from each
    frame's first pixel: blue ≡ 0 (mod 4) is no board, green picks the FEN."""

    device = torch.device("cpu")

    def __init__(self) -> None:
        self.batches: list[tuple[tuple, bytes]] = []

    def process_batch(self, batch: np.ndarray) -> SimpleNamespace:
        self.batches.append((batch.shape, batch.tobytes()))
        found = batch[:, 0, 0, 0] % 4 != 0
        fens = [FENS[int(g) % len(FENS)] if f else "" for f, g in zip(found, batch[:, 0, 0, 1])]
        return SimpleNamespace(board_found=found, fens=fens)


def _stand_in_items() -> list:
    """11 frames: 9 of 40×40 (a chunk of 8 and a padded tail of 1), then 2
    of 30×50 (a padded chunk), interleaved."""
    rng = np.random.default_rng(3)
    items = []
    for i in range(11):
        shape = (30, 50, 3) if i in (4, 9) else (40, 40, 3)
        img = rng.integers(0, 256, shape, np.uint8)
        img[0, 0, :2] = (i % 4, i)  # frames 0, 4 and 8 show no board
        items.append((img, f"img{i:02d}.JPG", FENS[0]))
    return items


def _run_jax_goldens(monkeypatch, items, out: Path) -> ReadingEngine:
    fake = ReadingEngine()
    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: SimpleNamespace(engine=fake), raising=False)
    monkeypatch.setattr(jeval, "get_test_generator", lambda *a, **k: iter(items))
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # the script appends to it
    script = _script("make_fen_goldens")
    monkeypatch.setattr(script, "OUT", out)
    script.main()
    return fake


def _run_port_goldens(monkeypatch, items, out: Path) -> ReadingEngine:
    fake = ReadingEngine()
    monkeypatch.setattr(core, "ChessVision", lambda **kw: SimpleNamespace(engine=fake))
    monkeypatch.setattr(port_eval, "get_test_generator", lambda *a, **k: iter(items))
    make_fen_goldens.main(["--out", str(out)])
    return fake


def test_make_fen_goldens_matches_the_script(monkeypatch, tmp_path) -> None:
    items = _stand_in_items()
    jax_fake = _run_jax_goldens(monkeypatch, items, tmp_path / "jax.json")
    port_fake = _run_port_goldens(monkeypatch, items, tmp_path / "port.json")
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["platform"] == want["platform"] == "cpu"
    assert got["results"] == want["results"]
    assert port_fake.batches == jax_fake.batches
    assert [shape for shape, _ in port_fake.batches] == [(8, 40, 40, 3), (8, 40, 40, 3), (8, 30, 50, 3)]
    assert sum(not r["found"] for r in got["results"].values()) == 3
    assert len(got["results"]) == 11


def test_make_fen_goldens_refuses_duplicate_names_as_the_script(monkeypatch, tmp_path) -> None:
    items = _stand_in_items()
    items[5] = (items[5][0], items[1][1], items[5][2])
    with pytest.raises(SystemExit) as jax_exit:
        _run_jax_goldens(monkeypatch, items, tmp_path / "jax.json")
    with pytest.raises(SystemExit) as port_exit:
        _run_port_goldens(monkeypatch, items, tmp_path / "port.json")
    assert str(port_exit.value) == str(jax_exit.value)
    assert "img01.JPG" in str(port_exit.value)
    assert not (tmp_path / "jax.json").exists() and not (tmp_path / "port.json").exists()


def _altered(goldens: dict, case: str) -> tuple[dict, int]:
    """(goldens altered as ``case`` says, the floor of exact matches)."""
    out = {k: dict(v) for k, v in goldens.items()}
    n = len(out)
    if case == "one_square":
        out["img01.JPG"]["fen"] = moved_fen(out["img01.JPG"]["fen"], 1)
        return out, n - 1
    if case == "three_squares":  # the band's edge: within it
        out["img05.JPG"]["fen"] = moved_fen(out["img05.JPG"]["fen"], 3)
        return out, n - 1
    if case == "four_squares":
        out["img02.JPG"]["fen"] = moved_fen(out["img02.JPG"]["fen"], 4)
        return out, n - 1
    if case == "found_flipped":
        out["img03.JPG"]["found"] = not out["img03.JPG"]["found"]
        return out, n - 1
    if case == "floor":
        return out, 35
    return out, n


@pytest.mark.parametrize("case", ["exact", "one_square", "three_squares", "four_squares", "found_flipped", "floor"])
def test_gate_summary_matches_the_tpu_gate(case, monkeypatch, capsys, tmp_path) -> None:
    """``compare`` against ``scripts/tpu_drift_gate.py`` run on the same
    FENs and goldens: the summary, its failure strings and the exit code."""
    items = _stand_in_items()
    fake = SimpleNamespace(engine=ReadingEngine())
    goldens, floor = _altered(make_fen_goldens.engine_fens(fake, items), case)
    path = tmp_path / "goldens.json"
    path.write_text(json.dumps({"platform": "cpu", "results": goldens}, indent=1, sort_keys=True))
    goldens = json.loads(path.read_text())["results"]

    script = _script("tpu_drift_gate")
    monkeypatch.setattr(script, "GOLDENS", path)
    monkeypatch.setattr(script, "MIN_EXACT", floor)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: SimpleNamespace(engine=ReadingEngine()), raising=False)
    monkeypatch.setattr(jeval, "get_test_generator", lambda *a, **k: iter(items))
    rc = script.main()
    (want,) = _printed(capsys)

    fens = make_fen_goldens.engine_fens(fake, items)
    got = drift_gate.compare(fens, goldens, 3, floor, backend="tpu")
    assert got == want
    assert (1 if got["failures"] else 0) == rc
    expected = {
        "exact": [],
        "one_square": [],
        "three_squares": [],
        "four_squares": [f"img02.JPG: 4 squares differ from the CPU golden (band is 3): "
                         f"tpu={fens['img02.JPG']['fen']} golden={goldens['img02.JPG']['fen']}"],
        "found_flipped": ["img03.JPG: found flag drifted (tpu=True, golden=False)"],
        "floor": ["only 11/11 exact FEN matches (floor 35)"],
    }[case]
    assert got["failures"] == expected
    assert got["worst_square_diff"] == {"one_square": 1, "three_squares": 3, "four_squares": 4}.get(case, 0)

    # the port's whole gate on the same items (the root only has to exist)
    monkeypatch.setattr(port_eval, "get_test_generator", lambda *a, **k: iter(items))
    summary, gate_fens = drift_gate.gate(path, tmp_path, 3, floor, cv=SimpleNamespace(engine=ReadingEngine()))
    assert summary == {**want, "backend": "cpu", "failures": [f.replace("tpu=", "cpu=") for f in want["failures"]]}
    assert gate_fens == fens


def test_gate_exits_42_without_a_cuda_device() -> None:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "chessvision_tpu_torch.tools.drift_gate"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "skip" in json.loads(proc.stdout.strip().splitlines()[-1])


def test_gate_fails_on_a_test_root_without_images(monkeypatch, tmp_path) -> None:
    """With a card (stood in for here) and no images, or no test root, the
    gate fails before it builds a model: never 0, never the skip's 42."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(core, "ChessVision", lambda **kw: pytest.fail("the gate built a model"))
    goldens = tmp_path / "goldens.json"
    goldens.write_text(json.dumps({"platform": "cpu", "results": {}}))
    (tmp_path / "empty" / "batch0" / "raw").mkdir(parents=True)
    for root in (tmp_path / "empty", tmp_path / "absent"):
        with pytest.raises(SystemExit) as exit_info:
            drift_gate.main(["--goldens", str(goldens), "--test-root", str(root)])
        assert exit_info.value.code not in (0, 42, None)
        assert "drift gate" in str(exit_info.value.code)


# -- the grid-refinement tools on both packages' engines --------------------------------

SHADES = np.linspace(0.0, 1.0, 13, dtype=np.float32)
SHARPNESS = 400.0


class ShadeClassifier(nn.Module):
    """Logits −k·(mean − shade_c)²: the class whose shade lies nearest the
    square's mean wins, with a confidence that moves with the square."""

    def __init__(self) -> None:
        super().__init__()
        self.register_buffer("shades", torch.from_numpy(SHADES))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = x.float().mean(dim=(1, 2, 3))
        return -SHARPNESS * (m[:, None] - self.shades[None, :]) ** 2


class JaxShadeClassifier:
    def apply(self, variables, x, **kw):
        m = x.astype(jnp.float32).mean(axis=(1, 2, 3))
        return -SHARPNESS * (m[:, None] - jnp.asarray(SHADES)[None, :]) ** 2


@pytest.fixture(scope="module")
def shade_engines():
    seg = _quad_logits(STUB_QUAD)
    port = Engine(StubExtractor(seg), ShadeClassifier(), device="cpu")
    ref = JaxEngine(JaxStub(seg, "extractor"), {}, JaxShadeClassifier(), {})
    return port, ref


@pytest.fixture(scope="module")
def test_root(tmp_path_factory) -> Path:
    return write_test_root(tmp_path_factory.mktemp("testset"), 3, seed=21, sizes=(256, 320))


def _printed(capsys) -> list[dict]:
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _both(monkeypatch, capsys, shade_engines, test_root, script_name: str, script_argv: list, port_main, port_argv):
    """Printed JSON lines of the script and of the port's ``main`` on the
    same test root and stub engines: (script's, port's)."""
    port, ref = shade_engines
    jax_items = list(jeval.get_test_generator(test_root))
    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: SimpleNamespace(engine=ref), raising=False)
    monkeypatch.setattr(jeval, "get_test_generator", lambda *a, **k: iter(jax_items))
    monkeypatch.setattr(sys, "argv", [f"{script_name}.py", *script_argv])
    assert _script(script_name).main() == 0
    want = _printed(capsys)
    monkeypatch.setattr(core, "ChessVision", lambda **kw: SimpleNamespace(engine=port))
    assert port_main([*port_argv, "--device", "cpu", "--test-root", str(test_root)]) == 0
    return want, _printed(capsys)


def test_debug_gridfix_records_match_the_script(shade_engines, test_root, monkeypatch, capsys) -> None:
    want, got = _both(monkeypatch, capsys, shade_engines, test_root, "debug_gridfix", [], debug_gridfix.main, [])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("backend", "image", "found", "chosen", "fen0", "fen1", "true_fen"):
            assert g[key] == w[key], (key, g, w)
        np.testing.assert_allclose(g["corr"], w["corr"], atol=1e-3)
        np.testing.assert_allclose([g["conf0"], g["conf1"]], [w["conf0"], w["conf1"]], atol=1e-5)
    assert {g["chosen"] for g in got} == {"original", "refined"}
    assert len({g["fen0"] for g in got} | {g["fen1"] for g in got}) > 1


def test_debug_gridfix_summary_and_dump_match_the_script(shade_engines, test_root, monkeypatch, capsys, tmp_path) -> None:
    monkeypatch.setenv("CVTPU_DEBUG_DUMP", str(tmp_path / "jax_dump.json"))
    port, ref = shade_engines
    jax_items = list(jeval.get_test_generator(test_root))
    monkeypatch.setattr(chessvision_tpu, "ChessVision", lambda **kw: SimpleNamespace(engine=ref), raising=False)
    monkeypatch.setattr(jeval, "get_test_generator", lambda *a, **k: iter(jax_items))
    monkeypatch.setattr(sys, "argv", ["debug_gridfix.py", "--summary"])
    assert _script("debug_gridfix").main() == 0
    (want,) = _printed(capsys)
    monkeypatch.setenv("CVTPU_DEBUG_DUMP", str(tmp_path / "port_dump.json"))
    monkeypatch.setenv("CVTPU_DEBUG_CPU", "1")  # the CPU, whatever --device says
    monkeypatch.setattr(core, "ChessVision", lambda device, **kw: SimpleNamespace(engine=port) if device == "cpu" else None)
    assert debug_gridfix.main(["--summary", "--test-root", str(test_root)]) == 0
    (got,) = _printed(capsys)
    assert got["wrong_squares"] == want["wrong_squares"]
    assert (got["backend"], got["images"]) == (want["backend"], want["images"]) == ("cpu", 3)
    assert [(t["image"], t["e0"], t["e1"]) for t in got["near_ties_with_consequence"]] == [
        (t["image"], t["e0"], t["e1"]) for t in want["near_ties_with_consequence"]]
    np.testing.assert_allclose([t["gap"] for t in got["near_ties_with_consequence"]],
                               [t["gap"] for t in want["near_ties_with_consequence"]], atol=1e-5)
    want_dump = json.loads((tmp_path / "jax_dump.json").read_text())
    got_dump = json.loads((tmp_path / "port_dump.json").read_text())
    assert got_dump.keys() == want_dump.keys()
    for name, w in want_dump.items():
        g = got_dump[name]
        assert abs(g.pop("gap") - w.pop("gap")) <= 1e-5
        assert g == w, name
    assert got["wrong_squares"]["original"] > 0


def test_exp_gridfix_quad_matches_the_script(shade_engines, test_root, monkeypatch, capsys) -> None:
    want, got = _both(monkeypatch, capsys, shade_engines, test_root, "exp_gridfix_quad", [], exp_gridfix_quad.main, [])
    assert got[-1] == want[-1]  # the totals line
    assert got[-1]["backend"] == "cpu" and got[-1]["sum_orig"] > 0
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.keys() == w.keys()
        for key in g:
            if key.startswith("c_"):
                assert abs(g[key] - w[key]) <= 1e-5, (key, g, w)
            else:
                assert g[key] == w[key], (key, g, w)
