"""The PyTorch port's engine and facade against the JAX package, on the CPU.

- stub-model engine tests mirrored from tests/test_engine.py, run through
  both engines on the same frames;
- validation rules on the same probability tables;
- the whole slice end to end at float32 with the committed weights
  (identical ``found`` and FENs, quads within 1e-3 px, probabilities
  atol 1e-3 in arbitrate mode and 1e-4 with refine="off"), on frames
  from scripts/make_screen_boards.compose;
- the arbitrate tail chunked and unchunked;
- no GPU: entry points raise unless asked for the CPU;
- the package never imports jax or chessvision_tpu.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from chessvision_tpu import constants as jconstants
from chessvision_tpu.chessboard import fen_to_labels
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu.engine import validate_labels_batch as jax_validate
from chessvision_tpu_torch import constants
from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.engine import Engine, validate_labels_batch
from chessvision_tpu_torch.synthetic import board_frames

REPO = Path(__file__).resolve().parent.parent
START_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"
STUB_QUAD = [[32, 28], [224, 30], [226, 228], [30, 226]]


def _fill_convex(pts: np.ndarray, size: int = 256) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    inside = np.ones((size, size), bool)
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % len(pts)]
        inside &= (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0) >= 0
    return inside


def _quad_logits(pts: list[list[int]]) -> np.ndarray:
    """+8 inside the (clockwise on screen) quad, -8 outside."""
    return np.where(_fill_convex(np.asarray(pts, np.float64)), 8.0, -8.0).astype(np.float32)


def _start_position_logits() -> np.ndarray:
    out = np.full((64, 13), -5.0, np.float32)
    for i, lab in enumerate(fen_to_labels(START_FEN)):
        out[i, constants.LABEL_INDICES[lab]] = 5.0
    return out


class StubExtractor(nn.Module):
    def __init__(self, logits_256: np.ndarray) -> None:
        super().__init__()
        self.register_buffer("logits", torch.from_numpy(logits_256))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits[None, :, :, None].expand(x.shape[0], 256, 256, 1)


class StubClassifier(nn.Module):
    def __init__(self, logits_64x13: np.ndarray) -> None:
        super().__init__()
        self.register_buffer("logits", torch.from_numpy(logits_64x13))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits.repeat(x.shape[0] // 64, 1)


class JaxStub:
    """The stub models for the JAX engine.  Their outputs carry a zero
    times the input, so that XLA cannot constant-fold the pipeline behind
    them (which costs seconds per compile); the values are unchanged."""

    def __init__(self, logits: np.ndarray, kind: str) -> None:
        self._logits = jnp.asarray(logits)
        self._kind = kind

    def apply(self, variables, x, **kw):
        if self._kind == "extractor":
            return jnp.broadcast_to(self._logits[None, :, :, None], (x.shape[0], 256, 256, 1)) + 0.0 * x[..., :1]
        return jnp.tile(self._logits, (x.shape[0] // 64, 1)) + 0.0 * x[:, 0, 0, :]


def _engines(seg_logits: np.ndarray, cls_logits: np.ndarray) -> tuple[Engine, JaxEngine]:
    port = Engine(StubExtractor(seg_logits), StubClassifier(cls_logits), device="cpu")
    ref = JaxEngine(JaxStub(seg_logits, "extractor"), {}, JaxStub(cls_logits, "classifier"), {})
    return port, ref


def _assert_same(got, want, prob_atol: float = 1e-5, quad_atol: float = 1e-3) -> None:
    np.testing.assert_array_equal(got.board_found, np.asarray(want.board_found))
    assert got.fens == want.fens
    assert got.original_fens == want.original_fens
    assert [[vars(f) for f in x] for x in got.validation_fixes] == [
        [vars(f) for f in x] for x in want.validation_fixes
    ]
    np.testing.assert_allclose(got.quadrangle, want.quadrangle, atol=quad_atol)
    np.testing.assert_allclose(got.probabilities, want.probabilities, atol=prob_atol)
    assert got.board_image.shape == want.board_image.shape
    assert got.logits.shape == want.logits.shape


@pytest.fixture(scope="module")
def stub_engines() -> tuple[Engine, JaxEngine]:
    return _engines(_quad_logits(STUB_QUAD), _start_position_logits())


# -- mirrored stub-engine tests (tests/test_engine.py) -------------------------------


def test_engine_end_to_end_fen(stub_engines) -> None:
    port, ref = stub_engines
    images = np.random.default_rng(0).integers(0, 256, (2, 512, 512, 3), np.uint8)
    result = port.process_batch(images, threshold=0.5)
    assert result.board_found.all()
    assert result.fens == [START_FEN, START_FEN]
    assert result.board_image.shape == (2, 512, 512) and result.board_image.dtype == np.uint8
    assert result.probabilities.shape == (2, 64, 13) and result.probabilities.dtype == np.float32
    assert result.quadrangle.shape == (2, 4, 2)
    assert 40 <= result.quadrangle[0, :, 0].min() <= 80
    assert result.validation_fixes[0] == []
    _assert_same(result, ref.process_batch(images, threshold=0.5))


def test_engine_flip_orientation(stub_engines) -> None:
    port, ref = stub_engines
    images = np.zeros((2, 512, 512, 3), np.uint8)  # the batch shape the fixture compiled
    result = port.process_batch(images, flip=True)
    want = "/".join("".join(reversed(row)) for row in reversed(START_FEN.split("/")))
    assert result.fens[0] == want
    assert result.fens == ref.process_batch(images, flip=True).fens


def test_engine_not_found_flag() -> None:
    port, ref = _engines(np.full((256, 256), -8.0, np.float32), _start_position_logits())
    images = np.zeros((1, 512, 512, 3), np.uint8)
    result = port.process_batch(images)
    assert not result.board_found.any()
    assert result.fens == [""] and result.validation_fixes == [[]]
    _assert_same(result, ref.process_batch(images))


def test_validation_rule_applied() -> None:
    logits = _start_position_logits()
    logits[0, :] = -5.0
    logits[0, constants.LABEL_INDICES["P"]] = 5.0
    logits[0, constants.LABEL_INDICES["r"]] = 4.0
    port, ref = _engines(_quad_logits(STUB_QUAD), logits)
    result = port.process_batch(np.zeros((1, 512, 512, 3), np.uint8))
    assert result.original_fens[0] == "Pnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"
    assert result.fens[0] == START_FEN
    (fix,) = result.validation_fixes[0]
    assert (fix.square_name, fix.original_piece, fix.corrected_piece, fix.rule_name) == (
        "a8", "P", "r", "no_pawns_on_ends"
    )
    _assert_same(result, ref.process_batch(np.zeros((1, 512, 512, 3), np.uint8)))


@pytest.mark.parametrize("refine", ["off", "detect", "arbitrate"])
def test_refine_modes_match_jax(refine) -> None:
    seg, cls = _quad_logits(STUB_QUAD), _start_position_logits()
    port = Engine(StubExtractor(seg), StubClassifier(cls), refine_grid=refine, device="cpu")
    ref = JaxEngine(JaxStub(seg, "extractor"), {}, JaxStub(cls, "classifier"), {}, refine_grid=refine)
    images = board_frames(seed=4, n=2)[0]
    got = port.process_batch(images)
    want = ref.process_batch(images)
    _assert_same(got, want)
    # XLA's jitted float32 homography algebra and PyTorch's round
    # differently in the last bits, which moves a rounded gray level by 1
    # on under 0.1% of pixels
    diff = np.abs(got.board_image.astype(int) - np.asarray(want.board_image).astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


def test_engine_non_512_frames(stub_engines) -> None:
    """768² frames take the matmul resize path (3×3 boxes); the quad scales
    by h / 256."""
    port, ref = stub_engines
    hw = (768, 768)
    images = np.random.default_rng(1).integers(0, 256, (2, *hw, 3), np.uint8)
    res = port.process_batch(images)
    assert list(res.board_found) == [True, True]
    assert res.board_image.shape == (2, 512, 512)
    assert 200.0 * hw[0] / 256 < res.quadrangle.max() <= hw[0]
    _assert_same(res, ref.process_batch(images))


def test_lite_skips_large_outputs(stub_engines) -> None:
    port, _ = stub_engines
    images = np.zeros((1, 512, 512, 3), np.uint8)
    full = port.process_batch(images)
    lite = port.process_batch(images, lite=True)
    assert lite.logits.shape == (1, 0, 0) and lite.board_image.shape == (1, 0, 0)
    assert lite.fens == full.fens
    np.testing.assert_array_equal(lite.probabilities, full.probabilities)
    with_board = port.process_batch(images, lite=True, include_board=True)
    np.testing.assert_array_equal(with_board.board_image, full.board_image)


# -- validation rules ------------------------------------------------------------------


def _validation_tables() -> list[np.ndarray]:
    f, K, k = constants.LABEL_INDICES["f"], constants.LABEL_INDICES["K"], constants.LABEL_INDICES["k"]
    tables = []
    rng = np.random.default_rng(7)
    for _ in range(3):
        logits = rng.normal(0, 2.0, (64, 13))
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        tables.append(p.astype(np.float32))
    two_kings = np.zeros((64, 13), np.float32)
    two_kings[:, f] = 0.9
    two_kings[20], two_kings[30] = 0, 0
    two_kings[20, k], two_kings[30, k], two_kings[30, f] = 0.8, 0.4, 0.3
    tables.append(two_kings)
    back_king = np.zeros((64, 13), np.float32)
    back_king[:, f] = 0.9
    back_king[20], back_king[3] = 0, 0
    back_king[20, K] = 0.9
    back_king[3, K], back_king[3, constants.LABEL_INDICES["p"]] = 0.5, 0.3
    back_king[3, k], back_king[3, constants.LABEL_INDICES["R"]] = 0.25, 0.2
    tables.append(back_king)
    missing = np.zeros((64, 13), np.float32)
    missing[:, f] = 0.9
    missing[20], missing[12] = 0, 0
    missing[20, K], missing[12, constants.LABEL_INDICES["q"]], missing[12, k] = 0.8, 0.4, 0.3
    tables.append(missing)
    empty = np.zeros((64, 13), np.float32)
    empty[:, f], empty[:, k], empty[:, K] = 0.99, 0.005, 0.005
    tables.append(empty)
    return tables


@pytest.mark.parametrize("flip", [False, True])
def test_validate_labels_batch_matches_jax(flip) -> None:
    probs = np.stack(_validation_tables())
    names = constants.SQUARE_NAMES_FLIPPED if flip else constants.SQUARE_NAMES_NORMAL
    assert names == (jconstants.SQUARE_NAMES_FLIPPED if flip else jconstants.SQUARE_NAMES_NORMAL)
    labels, fixes = validate_labels_batch(probs, names)
    want_labels, want_fixes = jax_validate(probs, names)
    assert labels == want_labels
    assert [[vars(f) for f in x] for x in fixes] == [[vars(f) for f in x] for x in want_fixes]
    assert any(fixes)  # the tables exercise the rules


# -- end to end with the committed weights ---------------------------------------------


@pytest.fixture(scope="module")
def compose_frames() -> np.ndarray:
    pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from make_screen_boards import compose
    finally:
        sys.path.remove(str(REPO / "scripts"))
    rng = np.random.default_rng(5)
    return np.stack([compose(rng, 512)[0] for _ in range(2)])


def test_end_to_end_f32_matches_jax(compose_frames) -> None:
    from chessvision_tpu.core import ChessVision as JaxChessVision

    ref = JaxChessVision(dtype=jnp.float32, refine_grid="arbitrate")
    want = ref.engine.process_batch(compose_frames)
    port = ChessVision(dtype=torch.float32, device="cpu")
    got = port.engine.process_batch(compose_frames)
    assert want.board_found.any()
    # Probabilities: atol 1e-3.  XLA's jitted float32 3×3 homography algebra
    # and PyTorch's round differently in the last bits, so the warped
    # boards differ by a few hundredths of a gray level; apply_correction
    # rounds its operands to bf16 (a step of one gray level above 128), so
    # a few hundred pixels of the corrected board move by a whole step.
    # The corrected side's probabilities then move by up to ~1e-3 and the
    # blend by 2.1e-4 on these frames (refine="off": 1.5e-5, tested below).
    _assert_same(got, want, prob_atol=1e-3, quad_atol=1e-3)
    # float32 UNets whose conv sums run in another order
    np.testing.assert_allclose(got.logits, want.logits, atol=2e-3)
    same = np.mean(got.board_image == np.asarray(want.board_image))
    assert same >= 0.999, same

    # the facade's single-image methods on one found frame
    i = int(np.argmax(got.board_found))
    frame, board = compose_frames[i], got.board_image[i]
    single = port.process_image(frame)
    assert single.position is not None and single.position.fen == got.fens[i]
    np.testing.assert_array_equal(single.board_extraction.board_image, board)
    pos = port.classify_position(board)
    want_pos = ref.classify_position(board)
    np.testing.assert_allclose(pos.model_probabilities, want_pos.model_probabilities, atol=1e-4)
    assert (pos.fen, pos.original_fen) == (want_pos.fen, want_pos.original_fen)
    ext = port.process_board_extraction_logits(got.logits[i], frame, 0.5)
    want_ext = ref.process_board_extraction_logits(got.logits[i], frame, 0.5)
    np.testing.assert_array_equal(ext.binary_mask, want_ext.binary_mask)
    np.testing.assert_allclose(ext.quadrangle, want_ext.quadrangle, atol=1e-3)
    assert np.mean(ext.board_image == want_ext.board_image) >= 0.999
    np.testing.assert_array_equal(ChessVision.extract_squares(board), JaxChessVision.extract_squares(board))


def test_end_to_end_f32_refine_off_matches_jax(compose_frames) -> None:
    """Without the bf16 correction resample, the models and the geometry
    agree with the JAX package to 1e-4 in probability."""
    from chessvision_tpu.core import ChessVision as JaxChessVision

    want = JaxChessVision(dtype=jnp.float32, refine_grid="off").engine.process_batch(compose_frames)
    got = ChessVision(dtype=torch.float32, device="cpu", refine_grid="off").engine.process_batch(compose_frames)
    assert want.board_found.any()
    _assert_same(got, want, prob_atol=1e-4, quad_atol=1e-3)


def test_arbitrate_chunked_matches_unchunked(compose_frames) -> None:
    """The arbitrate tail over chunks of 2 boards (2 + 1) and of 64 (one
    chunk) gives identical outputs: the Python loop that replaces the JAX
    package's lax.scan, and its short last chunk, change nothing."""
    images = np.concatenate([compose_frames, compose_frames[:1]])
    port = ChessVision(dtype=torch.float32, device="cpu")
    ex, cl = port.board_extractor[0], port.classifier[0]
    whole = Engine(ex, cl, arbitrate_chunk=64, device="cpu").process_batch(images)
    chunked = Engine(ex, cl, arbitrate_chunk=2, device="cpu").process_batch(images)
    np.testing.assert_array_equal(chunked.probabilities, whole.probabilities)
    np.testing.assert_array_equal(chunked.board_image, whole.board_image)
    np.testing.assert_array_equal(chunked.quadrangle, whole.quadrangle)
    np.testing.assert_array_equal(chunked.board_found, whole.board_found)
    assert chunked.fens == whole.fens
    assert engine_mod._ARBITRATE_CHUNK == 512


# -- devices and imports -------------------------------------------------------------------


def test_entry_points_raise_without_gpu() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChessVision()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(StubExtractor(np.zeros((256, 256), np.float32)), StubClassifier(np.zeros((64, 13), np.float32)))


def test_package_never_imports_jax() -> None:
    """Every module of the port, the port's three examples,
    ``bench_torch.py`` and ``graft_entry_torch.py`` import without JAX or
    the JAX package, and the
    port's native loader and packers never map a file of the JAX package's
    ``lib/`` (checked in the process's memory maps)."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import numpy as np\n"
        "import chessvision_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'chessvision_tpu_torch.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "for name in ('torch_quickstart', 'torch_detailed_example', 'torch_streaming_throughput'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    print('example', name)\n"
        "import bench_torch\n"
        "import graft_entry_torch\n"
        "from chessvision_tpu_torch import engine, native_loader\n"
        "native_loader.available()\n"
        "engine.pack_inputs_yuv444(np.zeros((1, 512, 512, 3), np.uint8))\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'chessvision_tpu')]\n"
        "bad += ['lib mapped'] if 'chessvision_tpu/lib' in maps else []\n"
        "print(len([m for m in sys.modules if m.startswith('chessvision_tpu_torch')]), bad)\n"
        "print(sorted(m for m in sys.modules if m.startswith('chessvision_tpu_torch')))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split("\n")[3].split()[0]) >= 50
    assert out.stdout.splitlines()[:3] == [
        "example torch_quickstart", "example torch_detailed_example", "example torch_streaming_throughput"
    ]
    for name in (
        "serve.server", "serve.webroot_server", "models.yolo", "profiling", "parallel.mesh", "ingest.pipeline",
        "ingest.merge", "tools.error_analysis", "tools.mine_warped_squares", "native_loader", "curation",
        "runstore.view", "train.sweep", "train.yolo_export", "typecheck", "tools.card", "tools.flops", "tools.bench",
        "tools.profile_stages", "tools.bench_training", "tools.mfu_accounting", "tools.sweep_arbitrate_chunk",
        "tools.microbench", "tools.make_fen_goldens", "tools.drift_gate", "tools.debug_gridfix",
        "tools.exp_gridfix_quad",
    ):
        assert f"'chessvision_tpu_torch.{name}'" in out.stdout
