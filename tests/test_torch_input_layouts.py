"""Frames and logits with a negative stride, on the CPU, against the JAX package.

``img[..., ::-1]`` (the usual RGB↔BGR view), ``np.flip(frames, 2)`` and
``frames[::-1]`` are numpy views with a negative stride, which
``torch.as_tensor`` refuses; the JAX package takes them.  The port makes
such an array contiguous where it turns a user's array into a tensor
(``utils.host_tensor``), and only such an array:

- the stub engines of tests/test_torch_engine.py at 256², B=2 (one shape
  throughout, so that JAX compiles once) on the three views:
  ``process_batch`` full and ``lite``, ``run_device``, the raw
  ``run_stream`` and ``Engine(mesh=…)`` at world size 1, each equal to the
  JAX engine's result on the view and to the port's own on the
  contiguous copy;
- the facade with the committed weights at float32: ``process_image``,
  ``extract_board`` and ``process_board_extraction_logits`` on
  channel-reversed and mirrored views;
- ``parallel.mesh.make_global_batch`` and ``host_gather``;
- positive-stride views (``[:, ::2, ::2]``, Fortran order) and tensors
  are not copied (``data_ptr``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.core import ChessVision as JaxChessVision
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.parallel import mesh as mesh_lib
from chessvision_tpu_torch.synthetic import board_frames
from tests.test_torch_engine import (
    STUB_QUAD,
    StubClassifier,
    StubExtractor,
    _assert_same,
    _engines,
    _quad_logits,
    _start_position_logits,
)

KEYS = ("logits", "quadrangle", "found", "board_image", "probabilities")
VIEWS = {
    "channels_reversed": lambda a: a[..., ::-1],
    "mirrored": lambda a: np.flip(a, 2),
    "batch_reversed": lambda a: a[::-1],
}


def _frames() -> np.ndarray:
    return np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3), np.uint8)


@pytest.fixture(scope="module")
def stubs():
    """The two stub engines, and per view the port's device outputs on the
    contiguous copy and the JAX engine's result on the view (each computed
    once)."""
    port, ref = _engines(_quad_logits(STUB_QUAD), _start_position_logits())
    frames = _frames()
    copies, jax_results = {}, {}
    for name, view in VIEWS.items():
        v = view(frames)
        assert any(s < 0 for s in v.strides)
        copies[name] = port.run_device(np.ascontiguousarray(v))
        jax_results[name] = ref.process_batch(v)
    return port, copies, jax_results


def _equal_outputs(got: dict, want: dict) -> None:
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert torch.equal(torch.as_tensor(np.asarray(got[k])), want[k]), k


def _equal_to_copy(res, want: dict, lite: bool = False) -> None:
    np.testing.assert_array_equal(res.board_found, want["found"].numpy())
    np.testing.assert_array_equal(res.quadrangle, want["quadrangle"].numpy())
    np.testing.assert_array_equal(res.probabilities, want["probabilities"].numpy())
    if not lite:
        np.testing.assert_array_equal(res.logits, want["logits"].numpy())
        np.testing.assert_array_equal(res.board_image, want["board_image"].numpy())


@pytest.mark.parametrize("lite", [False, True], ids=["full", "lite"])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_batch_takes_negatively_strided_frames(stubs, view, lite) -> None:
    port, copies, jax_results = stubs
    res = port.process_batch(VIEWS[view](_frames()), lite=lite)
    assert res.board_found.all()
    _equal_to_copy(res, copies[view], lite)
    want = jax_results[view]
    np.testing.assert_array_equal(res.board_found, np.asarray(want.board_found))
    assert res.fens == want.fens and res.original_fens == want.original_fens
    np.testing.assert_allclose(res.quadrangle, want.quadrangle, atol=1e-3)
    np.testing.assert_allclose(res.probabilities, want.probabilities, atol=1e-5)
    if not lite:
        _assert_same(res, want)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_run_device_and_the_raw_stream_take_negatively_strided_frames(stubs, view) -> None:
    port, copies, _ = stubs
    v = VIEWS[view](_frames())
    _equal_outputs(port.run_device(v), copies[view])
    (streamed,) = list(port.run_stream([v], kind="raw"))
    _equal_outputs(streamed, copies[view])


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_a_one_process_mesh_takes_negatively_strided_frames(stubs, view) -> None:
    _, copies, jax_results = stubs
    seg, cls = _quad_logits(STUB_QUAD), _start_position_logits()
    meshed = Engine(StubExtractor(seg), StubClassifier(cls), device="cpu", mesh=mesh_lib.create_mesh(device="cpu"))
    res = meshed.process_batch(VIEWS[view](_frames()))
    _equal_to_copy(res, copies[view])
    _assert_same(res, jax_results[view])


# -- the facade with the committed weights ---------------------------------------------------


@pytest.fixture(scope="module")
def facades():
    port = ChessVision(device="cpu", dtype=torch.float32)
    ref = JaxChessVision(dtype=jnp.float32)
    frame = board_frames(1, 1)[0][0]  # seed 1: a frame whose board the float32 models find
    return port, ref, frame


FRAME_VIEWS = {"channels_reversed": lambda a: a[..., ::-1], "mirrored": lambda a: np.flip(a, 1)}


@pytest.mark.parametrize("view", sorted(FRAME_VIEWS))
def test_facade_takes_negatively_strided_images(facades, view) -> None:
    port, ref, frame = facades
    v = FRAME_VIEWS[view](frame)
    assert any(s < 0 for s in v.strides)
    got, want, own = port.process_image(v), ref.process_image(v), port.process_image(np.ascontiguousarray(v))
    assert (got.position is None) == (want.position is None) == (own.position is None)
    np.testing.assert_array_equal(got.board_extraction.binary_mask, want.board_extraction.binary_mask)
    np.testing.assert_array_equal(got.board_extraction.probabilities, own.board_extraction.probabilities)
    if got.position is not None:
        assert got.position.fen == want.position.fen == own.position.fen
        np.testing.assert_allclose(got.board_extraction.quadrangle, want.board_extraction.quadrangle, atol=1e-3)
        np.testing.assert_allclose(got.position.model_probabilities, want.position.model_probabilities, atol=1e-3)
        np.testing.assert_array_equal(got.position.model_probabilities, own.position.model_probabilities)
    board = port.extract_board(v)
    np.testing.assert_array_equal(board.probabilities, own.board_extraction.probabilities)
    np.testing.assert_array_equal(board.binary_mask, want.board_extraction.binary_mask)
    assert (board.quadrangle is None) == (want.board_extraction.quadrangle is None)
    if board.quadrangle is not None:
        np.testing.assert_array_equal(board.quadrangle, own.board_extraction.quadrangle)
        np.testing.assert_array_equal(board.board_image, own.board_extraction.board_image)


def test_board_extraction_logits_take_negatively_strided_arrays(facades) -> None:
    port, ref, frame = facades
    logits = _quad_logits(STUB_QUAD)[::-1]  # the quad mirrored top to bottom
    image = frame[..., ::-1]
    got = port.process_board_extraction_logits(logits, image, 0.5)
    want = ref.process_board_extraction_logits(logits, image, 0.5)
    own = port.process_board_extraction_logits(np.ascontiguousarray(logits), np.ascontiguousarray(image), 0.5)
    assert got.quadrangle is not None and want.quadrangle is not None
    np.testing.assert_array_equal(got.binary_mask, np.asarray(want.binary_mask))
    np.testing.assert_allclose(got.quadrangle, np.asarray(want.quadrangle), atol=1e-3)
    diff = np.abs(got.board_image.astype(int) - np.asarray(want.board_image).astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    np.testing.assert_array_equal(got.quadrangle, own.quadrangle)
    np.testing.assert_array_equal(got.board_image, own.board_image)


# -- the mesh helpers and the copies ------------------------------------------------------------


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_mesh_helpers_take_negatively_strided_arrays(view) -> None:
    v = VIEWS[view](_frames())
    assert torch.equal(mesh_lib.make_global_batch(None, v), torch.from_numpy(np.ascontiguousarray(v)))
    # a mesh of two ranks without a process group gathers this rank's rows alone
    two = mesh_lib.Mesh(2, 0, torch.device("cpu"))
    np.testing.assert_array_equal(mesh_lib.host_gather(two, v), v)


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def test_positive_strides_and_tensors_are_not_copied() -> None:
    from chessvision_tpu_torch.utils import host_tensor

    frames = _frames()
    port = Engine(StubExtractor(_quad_logits(STUB_QUAD)), StubClassifier(_start_position_logits()), device="cpu")
    for v in (frames, frames[:, ::2, ::2], np.asfortranarray(frames)):
        assert host_tensor(v).data_ptr() == _ptr(v)
        assert port._on_device(v)[0].data_ptr() == _ptr(v)
        assert mesh_lib.make_global_batch(None, v).data_ptr() == _ptr(v)
    t = torch.from_numpy(frames)
    assert host_tensor(t) is t and port._on_device(t)[0] is t
    flipped = frames[..., ::-1]
    assert host_tensor(flipped).data_ptr() != _ptr(flipped)
    np.testing.assert_array_equal(host_tensor(flipped).numpy(), flipped)
