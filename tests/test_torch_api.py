"""Small API pieces of the port against the JAX package, on the CPU:
``chessboard.Piece``/``BaseBoard``, ``cv_types.ValidationMetrics``,
``ops/quad.find_quadrangle`` (single image: the same corners and flag on
the masks of tests/test_torch_ops.py), ``ops/squares.extract_squares``, the bilinear UNet (logits against
Flax's at float32, atol 1e-4), and the annotation gate
(``chessvision_tpu_torch.typecheck``) over the whole port."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import chessboard as jboard
from chessvision_tpu import cv_types as jtypes
from chessvision_tpu.models.unet import UNet as FlaxUNet
from chessvision_tpu.ops import quad as jquad
from chessvision_tpu_torch import ValidationMetrics, chessboard, typecheck, weights
from chessvision_tpu_torch.models import UNet
from chessvision_tpu_torch.ops import quad
from tests.test_torch_ops import _masks

FENS = ["rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR", "8/8/8/3k4/8/8/3K4/8", "r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1"]


@pytest.mark.parametrize("fen", FENS)
def test_base_board_matches_jax(fen) -> None:
    got, want = chessboard.BaseBoard(fen), jboard.BaseBoard(fen)
    assert got.board_fen() == want.board_fen()
    assert {k: v.symbol for k, v in got.piece_map().items()} == {k: v.symbol for k, v in want.piece_map().items()}
    for sq in (0, 4, 60, 63):
        a, b = got.piece_at(sq), want.piece_at(sq)
        assert (a is None and b is None) or a.symbol == b.symbol
    got.set_piece_at(27, chessboard.Piece("Q"))
    want.set_piece_at(27, jboard.Piece("Q"))
    got.set_piece_at(0, None)
    want.set_piece_at(0, None)
    assert got.board_fen() == want.board_fen()
    assert got == chessboard.BaseBoard(got.board_fen()) and chessboard.BaseBoard.empty().board_fen() == "8/8/8/8/8/8/8/8"


@pytest.mark.parametrize("bad", ["8/8/8", "9/8/8/8/8/8/8/8", "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNX"])
def test_base_board_rejects_like_jax(bad) -> None:
    with pytest.raises(ValueError):
        jboard.BaseBoard(bad)
    with pytest.raises(ValueError):
        chessboard.BaseBoard(bad)
    with pytest.raises(ValueError):
        chessboard.Piece("x")


def test_validation_metrics_matches_jax() -> None:
    got, want = ValidationMetrics(0.9, 0.95, 2, []), jtypes.ValidationMetrics(0.9, 0.95, 2, [])
    assert got.accuracy_delta == want.accuracy_delta and got.num_fixes == want.num_fixes


@pytest.mark.parametrize("name", sorted(_masks()))
def test_find_quadrangle_matches_jax(name) -> None:
    m = _masks()[name]
    q, f = quad.find_quadrangle(torch.from_numpy(m), 0.5)
    jq, jf = jquad.find_quadrangle(jnp.asarray(m), 0.5)
    assert q.shape == (4, 2) and f.shape == () and bool(f) == bool(jf)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_extract_squares_single_board_matches_jax() -> None:
    from chessvision_tpu.ops.squares import extract_squares as jextract

    from chessvision_tpu_torch.ops import extract_squares

    board = np.random.default_rng(2).random((512, 512)).astype(np.float32)
    got = extract_squares(torch.from_numpy(board)).numpy()
    assert got.shape == (64, 64, 64, 1) and np.array_equal(got, np.asarray(jextract(jnp.asarray(board))))


def test_bilinear_unet_matches_flax() -> None:
    flax_model = FlaxUNet(base=4, bilinear=True, dtype=jnp.float32)
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    variables = jax.jit(flax_model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree.map(np.asarray, variables)
    model = UNet(base=4, bilinear=True)
    model.load_state_dict(weights.flax_to_torch(variables, model))
    model.eval()
    with torch.inference_mode():
        got, feat = model(torch.from_numpy(x), return_features=True)
    want, wfeat = jax.jit(lambda v, a: flax_model.apply(v, a, return_features=True))(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), atol=1e-4)


def test_port_annotations_resolve() -> None:
    errors = typecheck.run()
    assert not errors, "annotation drift:\n" + "\n".join(errors)


def test_checker_catches_bad_annotation() -> None:
    mod = types.ModuleType("fake_mod")
    src = (
        "from __future__ import annotations\n"
        "def broken(x: NoSuchType) -> None: ...\n"
        "def implicit(x: int = None) -> None: ...\n"
    )
    exec(compile(src, "<fake>", "exec"), mod.__dict__)
    mod.broken.__module__ = "fake_mod"
    mod.implicit.__module__ = "fake_mod"
    errors: list[str] = []
    typecheck.check_module(mod, errors)
    assert any("NoSuchType" in e or "unresolvable" in e for e in errors), errors
    assert any("implicit" in e and "Optional" in e for e in errors), errors
