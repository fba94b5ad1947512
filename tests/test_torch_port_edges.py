"""Three situations where the port once gave other results than the JAX
package, on the CPU.

- An empty batch: every engine entry at B=0 (``process_batch`` full,
  ``lite`` and with ``include_board``; ``run_device``; the raw
  ``run_stream``; ``run_packed``, ``run_yuv`` and ``run_yuv444`` on
  zero-row arrays of the packers' shapes; ``Engine(mesh=…)``; every refine
  mode) returns the JAX package's fields with its shapes and dtypes.  The
  packers themselves raise the same exception class in both packages.
- ``CVTPU_ROOT`` and ``CVTPU_DATA_ROOT``, in a subprocess each: both
  packages' ``REPO_ROOT``, ``WEIGHTS_DIR``, ``BEST_*`` paths, data root and
  run store root are equal; the web UI stays on the checkout.
- The engine's environment: ``CVTPU_REFINE`` (read when an engine is
  built) in this process, and ``CVTPU_REFINE_MARGIN`` (read when the
  engine module is imported) in a subprocess, through both engines with
  the stub models of tests/test_torch_engine.py on synthetic frames:
  ``found`` and FENs equal, quads within 1e-3 px, probabilities within
  1e-5 (``_assert_same``).  ``CVTPU_ARBITRATE_CHUNK`` sets each rank's
  chunk as it sets each device's in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import engine as jengine
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu.parallel import mesh as jmesh
from chessvision_tpu_torch import engine as tengine
from chessvision_tpu_torch.cv_types import BatchResult
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.parallel import mesh as tmesh
from chessvision_tpu_torch.synthetic import board_frames
from tests.test_torch_engine import (
    STUB_QUAD,
    JaxStub,
    StubClassifier,
    StubExtractor,
    _assert_same,
    _quad_logits,
    _start_position_logits,
)

REPO = Path(__file__).resolve().parent.parent
SEG, CLS = _quad_logits(STUB_QUAD), _start_position_logits()


def _pair(refine: str | None = None, mesh: bool = False) -> tuple[Engine, JaxEngine]:
    port = Engine(
        StubExtractor(SEG), StubClassifier(CLS), refine_grid=refine, device="cpu",
        mesh=tmesh.create_mesh(device="cpu") if mesh else None,
    )
    ref = JaxEngine(
        JaxStub(SEG, "extractor"), {}, JaxStub(CLS, "classifier"), {}, refine_grid=refine,
        mesh=jmesh.create_mesh() if mesh else None,
    )
    return port, ref


def _layout(x) -> object:
    """What a result is made of: per array field its shape and dtype, the
    other fields as they are."""
    if isinstance(x, dict):
        return {k: _layout(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [_layout(v) for v in x]
    if dataclasses.is_dataclass(x):
        return {"type": type(x).__name__, **{f.name: _layout(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if hasattr(x, "shape"):
        a = np.asarray(x)
        return (a.shape, str(a.dtype))
    return x


# -- an empty batch --------------------------------------------------------------------

FRAMES0 = np.zeros((0, 512, 512, 3), np.uint8)
# zero-row arrays of each packer's output shapes at 512² frames
PACKED0 = {
    "packed": ((0, 256, 256, 3), (0, 512, 512)),
    "yuv": ((0, 512, 512), (0, 128, 128), (0, 128, 128)),
    "yuv444": ((0, 512, 512), (0, 256, 256), (0, 256, 256), (0, 256, 128)),
}
PACKERS = {"packed": "pack_inputs", "yuv": "pack_inputs_yuv", "yuv444": "pack_inputs_yuv444"}
BATCH_CALLS = {
    "full": {},
    "lite": {"lite": True},
    "lite_board": {"lite": True, "include_board": True},
    "include_board": {"include_board": True},
    "flip": {"flip": True},
}


@pytest.fixture(scope="module")
def pair() -> tuple[Engine, JaxEngine]:
    return _pair("arbitrate")


@pytest.mark.parametrize("call", sorted(BATCH_CALLS))
def test_process_batch_of_no_frames_matches_jax(pair, call) -> None:
    port, ref = pair
    got = port.process_batch(FRAMES0, **BATCH_CALLS[call])
    want = ref.process_batch(FRAMES0, **BATCH_CALLS[call])
    assert isinstance(got, BatchResult)
    assert _layout(got) == _layout(want)
    assert got.fens == got.original_fens == got.validation_fixes == []
    assert got.board_image.shape == ((0, 0, 0) if call == "lite" else (0, 512, 512))


def test_run_device_and_raw_stream_of_no_frames_match_jax(pair) -> None:
    port, ref = pair
    got = port.run_device(torch.zeros((0, 512, 512, 3), dtype=torch.uint8))
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    assert _layout(got) == _layout(ref.run_device(jnp.zeros((0, 512, 512, 3), jnp.uint8)))
    streamed = list(port.run_stream([FRAMES0], kind="raw"))
    want = list(ref.run_stream([FRAMES0], kind="raw"))
    assert len(streamed) == len(want) == 1
    assert _layout(streamed) == _layout(want)


@pytest.mark.parametrize("kind", sorted(PACKED0))
def test_packed_entries_on_no_rows_match_jax(pair, kind) -> None:
    """The packers refuse an empty batch alike; the entries they feed take
    zero-row arrays of their shapes, directly and streamed."""
    port, ref = pair
    for eng_mod in (tengine, jengine):
        with pytest.raises(ValueError, match="need at least one array"):
            getattr(eng_mod, PACKERS[kind])(FRAMES0)
    arrays = tuple(np.zeros(s, np.uint8) for s in PACKED0[kind])
    run = {"packed": "run_packed", "yuv": "run_yuv", "yuv444": "run_yuv444"}[kind]
    got = getattr(port, run)(*arrays)
    assert _layout(got) == _layout(getattr(ref, run)(*arrays))
    assert _layout(list(port.run_stream([arrays], kind=kind))) == _layout(list(ref.run_stream([arrays], kind=kind)))


@pytest.mark.parametrize("refine", ["off", "detect"])
def test_other_refine_modes_on_no_frames_match_jax(refine) -> None:
    port, ref = _pair(refine)
    assert _layout(port.process_batch(FRAMES0)) == _layout(ref.process_batch(FRAMES0))


@pytest.mark.parametrize("lite", [False, True], ids=["full", "lite"])
def test_mesh_engine_on_no_frames_matches_jax(lite) -> None:
    """``Engine(mesh=…)``: ``pad_to_multiple`` leaves no rows as they are and
    the mesh runs them (the JAX mesh spans the test's 8 CPU devices; on a
    mesh ``lite`` takes the full path in both)."""
    port, ref = _pair("arbitrate", mesh=True)
    got = port.process_batch(FRAMES0, lite=lite)
    assert _layout(got) == _layout(ref.process_batch(FRAMES0, lite=lite))
    assert got.board_image.shape == (0, 512, 512)


# -- CVTPU_ROOT and the data root ------------------------------------------------------

_ROOTS_CODE = """
import importlib, json, os, sys
from chessvision_tpu import constants as jc
from chessvision_tpu.runstore import tables as jt
from chessvision_tpu.serve import webroot_server as jw
from chessvision_tpu_torch import constants as tc
from chessvision_tpu_torch.runstore import tables as tt
from chessvision_tpu_torch.serve import webroot_server as tw

def roots(c, t):
    names = ("REPO_ROOT", "WEIGHTS_DIR", "DATA_ROOT", "BEST_EXTRACTOR_WEIGHTS", "BEST_CLASSIFIER_WEIGHTS",
             "BEST_YOLO_EXTRACTOR", "BEST_YOLO_CLASSIFIER")
    out = {n: str(getattr(c, n)) for n in names}
    out.update(store_default=str(t._DEFAULT_ROOT), store_root=str(t.store_root()))
    return out

got = {}
for case, env in json.loads(sys.argv[1]).items():
    for k in ("CVTPU_ROOT", "CVTPU_DATA_ROOT", "CVTPU_STORE_ROOT"):
        os.environ.pop(k, None)
    os.environ.update(env)
    # both packages read the variables when these modules are imported
    for m in (jc, jt, jw, tc, tt, tw):
        importlib.reload(m)
    got[case] = {"jax": roots(jc, jt), "port": {**roots(tc, tt), "data_root()": str(tc.data_root())},
                 "jax_webroot": str(jw.WEBROOT.resolve()), "port_webroot": str(tw.WEBROOT)}
print(json.dumps(got))
"""
ROOT_CASES = ["root", "root_with_data", "data_root", "both"]


@pytest.fixture(scope="module")
def roots_by_case(tmp_path_factory) -> dict:
    """Each case's environment and what both packages make of it, from one
    child process that re-imports the modules for each case."""
    tmp = tmp_path_factory.mktemp("roots")
    root, data = tmp / "elsewhere", tmp / "datasets"
    (tmp / "with_data" / "data").mkdir(parents=True)
    envs = {
        "root": {"CVTPU_ROOT": str(root)},
        "root_with_data": {"CVTPU_ROOT": str(tmp / "with_data")},
        "data_root": {"CVTPU_DATA_ROOT": str(data)},
        "both": {"CVTPU_ROOT": str(root), "CVTPU_DATA_ROOT": str(data)},
    }
    out = subprocess.run([sys.executable, "-c", _ROOTS_CODE, json.dumps(envs)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    return {case: (envs[case], got[case]) for case in ROOT_CASES}


@pytest.mark.parametrize("case", ROOT_CASES)
def test_roots_follow_the_environment_as_in_jax(roots_by_case, case) -> None:
    env, got = roots_by_case[case]
    port = dict(got["port"])
    assert port.pop("data_root()") == port["DATA_ROOT"]
    assert port == got["jax"]
    want_root = Path(env["CVTPU_ROOT"]) if "CVTPU_ROOT" in env else REPO
    assert Path(port["REPO_ROOT"]).resolve() == want_root.resolve()
    assert port["BEST_EXTRACTOR_WEIGHTS"] == str(Path(port["REPO_ROOT"]) / "weights" / "best_extractor.npz")
    assert port["store_root"] == str(Path(port["REPO_ROOT"]) / "store")
    want_data = Path(env["CVTPU_DATA_ROOT"]) if "CVTPU_DATA_ROOT" in env else want_root / "data"
    assert Path(port["DATA_ROOT"]).resolve() == want_data.resolve()
    # the static UI is served from the checkout whatever the root
    assert got["port_webroot"] == got["jax_webroot"] == str(REPO / "chessvision_tpu" / "serve" / "webroot")


# -- the engine's environment ----------------------------------------------------------


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    return board_frames(seed=4, n=2)[0]


def _boards_close(got: np.ndarray, want) -> None:
    # one gray level on under 0.1% of pixels, as test_refine_modes_match_jax
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, (diff.max(), np.mean(diff == 0))


@pytest.mark.parametrize("refine", ["off", "detect"])
def test_cvtpu_refine_selects_the_mode_as_in_jax(monkeypatch, frames, refine) -> None:
    monkeypatch.setenv("CVTPU_REFINE", refine)
    port, ref = _pair(None)
    assert port._refine == ref._refine == refine
    got, want = port.process_batch(frames), ref.process_batch(frames)
    _assert_same(got, want)
    _boards_close(got.board_image, want.board_image)
    # an explicit mode wins over the variable, in both
    assert _pair("arbitrate")[0]._refine == "arbitrate"
    monkeypatch.setenv("CVTPU_REFINE", "sideways")
    for build in (lambda: Engine(StubExtractor(SEG), StubClassifier(CLS), device="cpu"),
                  lambda: JaxEngine(JaxStub(SEG, "extractor"), {}, JaxStub(CLS, "classifier"), {})):
        with pytest.raises(ValueError, match="unknown refine_grid mode"):
            build()


def test_facade_passes_no_mode_through_to_the_engine(monkeypatch) -> None:
    """``ChessVision(refine_grid=None)`` leaves the choice to the engine,
    which reads ``CVTPU_REFINE``, as the JAX facade does."""
    from chessvision_tpu.core import ChessVision as JaxChessVision
    from chessvision_tpu_torch.core import ChessVision

    monkeypatch.setenv("CVTPU_REFINE", "detect")
    port = ChessVision(device="cpu", dtype=torch.float32)
    ref = JaxChessVision(dtype=jnp.float32)
    assert port.engine._refine == ref.engine._refine == "detect"


@pytest.mark.parametrize("chunk", [None, "3"])
def test_cvtpu_arbitrate_chunk_is_each_ranks_chunk(monkeypatch, chunk) -> None:
    """The variable is a device's chunk in the JAX package and a rank's in
    the port; unset, the port keeps its 512 a rank (the JAX package 128)."""
    if chunk is None:
        monkeypatch.delenv("CVTPU_ARBITRATE_CHUNK", raising=False)
    else:
        monkeypatch.setenv("CVTPU_ARBITRATE_CHUNK", chunk)
    port, ref = _pair("arbitrate")
    mesh_port, mesh_ref = _pair("arbitrate", mesh=True)
    if chunk is None:
        assert (port._arbitrate_chunk, ref._arbitrate_chunk) == (tengine._ARBITRATE_CHUNK, jengine._ARBITRATE_CHUNK)
    else:
        assert port._arbitrate_chunk == ref._arbitrate_chunk == int(chunk)
        # per device in JAX (8 CPU devices), per rank in the port (one rank)
        assert mesh_ref._arbitrate_chunk == int(chunk) * mesh_ref.mesh.size
        assert mesh_port._arbitrate_chunk == int(chunk)
    # an explicit chunk wins over the variable
    assert Engine(StubExtractor(SEG), StubClassifier(CLS), arbitrate_chunk=2, device="cpu")._arbitrate_chunk == 2


_MARGIN_CODE = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from chessvision_tpu import engine as jengine
from chessvision_tpu_torch import engine as tengine
from chessvision_tpu_torch.synthetic import board_frames
from tests.test_torch_port_edges import _boards_close, _pair
from tests.test_torch_engine import _assert_same

print("margins", jengine._REFINE_MARGIN, tengine._REFINE_MARGIN)
sizes = []
warp = tengine.warp_perspective
tengine.warp_perspective = lambda gray, ms, size: sizes.append(tuple(size)) or warp(gray, ms, size)
frames = board_frames(seed=4, n=2)[0]
port, ref = _pair("arbitrate")
got, want = port.process_batch(frames), ref.process_batch(frames)
_assert_same(got, want)
_boards_close(got.board_image, want.board_image)
assert got.board_found.all(), got.board_found
print("fens", got.fens)
print("canvases", sizes)
"""


@pytest.mark.parametrize("margin", [0, 16])
def test_cvtpu_refine_margin_matches_jax(margin) -> None:
    """The margin is read when the engine module is imported, so a child
    process with the variable set runs both engines in arbitrate mode (a
    512² canvas at 0, 544² at 16, through the warp and ``apply_correction``
    at that size)."""
    env = dict(os.environ, CVTPU_REFINE_MARGIN=str(margin), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _MARGIN_CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert f"margins {margin} {margin}" in out.stdout
    side = 512 + 2 * margin
    assert f"canvases {[(side, side)]}" in out.stdout
    assert out.stdout.count("rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR") == 2
