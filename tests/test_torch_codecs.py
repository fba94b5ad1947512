"""The port's input codecs and ``run_stream`` against the JAX package, on the CPU.

- the three host packers equal the JAX package's bit for bit (dtype too),
  and ``pack_inputs``' numpy branch equals its cv2 branch;
- ``reconstruct_comp_yuv444`` (int32, tolerance 0) equals the JAX function
  on any bytes and ``pack_inputs``' comp wherever nothing clipped;
- ``run_packed`` / ``run_yuv444`` are bit-identical to the raw path (all
  five outputs) and, like ``run_yuv``, give the JAX engine's outputs for
  the same packed inputs on the stub models; ``run_yuv``'s reconstruction
  stays within the JAX test's error bounds (mean < 1.5, p99 ≤ 6 gray
  levels) and within 1 gray level of what the JAX ``run_yuv`` hands its
  extractor;
- ``run_stream`` yields the non-streamed outputs, in order, for all four
  kinds, handles empty and one-element iterators, and draws batch i+1
  only after it has dispatched batch i;
- ``resize`` takes the JAX ``resize``'s four input ranks.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import engine as jengine
from chessvision_tpu.ops.resize import resize as jax_resize
from chessvision_tpu_torch import models
from chessvision_tpu_torch.engine import (
    Engine,
    pack_inputs,
    pack_inputs_yuv,
    pack_inputs_yuv444,
    reconstruct_comp_yuv,
    reconstruct_comp_yuv444,
)
from chessvision_tpu_torch.ops.resize import resize
from chessvision_tpu_torch.synthetic import board_frames, limit_chroma
from tests.test_torch_engine import (
    STUB_QUAD,
    JaxStub,
    StubClassifier,
    StubExtractor,
    _engines,
    _quad_logits,
    _start_position_logits,
)

PACKERS = {"pack_inputs": pack_inputs, "pack_inputs_yuv": pack_inputs_yuv, "pack_inputs_yuv444": pack_inputs_yuv444}
KEYS = ("logits", "quadrangle", "found", "board_image", "probabilities")


def _smooth_frames(seed: int, n: int, size: int) -> np.ndarray:
    """Blocky, mildly saturated frames with ±3 noise: chroma differences
    stay inside int8, as in board photos."""
    rng = np.random.default_rng(seed)
    base = rng.integers(80, 176, (n, 8, 8, 3))
    up = np.kron(base, np.ones((1, size // 8, size // 8, 1), np.int64))
    return np.clip(up + rng.integers(-3, 4, up.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    """Two synthetic board frames as made (saturated clutter: chroma clips)
    and the same two with limited chroma."""
    raw = board_frames(seed=11, n=2)[0]
    return np.concatenate([raw, limit_chroma(raw)])


def _stub_engine(extractor: str = "stub") -> Engine:
    if extractor == "stub":
        ex = StubExtractor(_quad_logits(STUB_QUAD))
    else:  # a small segmenter with seeded random weights: its logits depend on the color input
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            ex = models.create_extractor("yolo", width=8)[0]
    return Engine(ex, StubClassifier(_start_position_logits()), device="cpu")


# -- host packers --------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PACKERS))
@pytest.mark.parametrize("size", [512, 1024])
def test_packers_match_jax(frames, name, size) -> None:
    imgs = frames if size == 512 else _smooth_frames(0, 1, size)
    got = PACKERS[name](imgs)
    want = getattr(jengine, name)(imgs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_packed_sizes_per_board(frames) -> None:
    """Bytes per 512² board, from the arrays: raw 768 KiB, packed 448 KiB,
    yuv444 416 KiB, yuv 288 KiB."""
    per_board = {name: sum(a.nbytes for a in fn(frames)) // len(frames) for name, fn in PACKERS.items()}
    assert frames.nbytes // len(frames) == 768 * 1024
    assert per_board == {"pack_inputs": 448 * 1024, "pack_inputs_yuv": 288 * 1024, "pack_inputs_yuv444": 416 * 1024}


def test_pack_inputs_numpy_branch_equals_cv2(monkeypatch, frames) -> None:
    """On 512² frames (block factor 2) all three packers give the same
    bytes with and without cv2."""
    pytest.importorskip("cv2")
    imgs = frames
    with_cv2 = [fn(imgs) for fn in PACKERS.values()]
    monkeypatch.setitem(sys.modules, "cv2", None)  # makes ``import cv2`` raise ImportError
    for want, fn in zip(with_cv2, PACKERS.values()):
        for g, w in zip(fn(imgs), want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="divisible"):
        pack_inputs(np.zeros((1, 500, 500, 3), np.uint8))


def test_yuv_pack_size_guards_and_factors() -> None:
    bad = np.zeros((1, 500, 500, 3), np.uint8)
    with pytest.raises(ValueError):
        pack_inputs_yuv444(bad)
    with pytest.raises(ValueError):
        pack_inputs_yuv(bad)
    # 4:2:0 keeps taking integer factors that are no power of two (768²)
    imgs768 = np.random.default_rng(5).integers(0, 256, (1, 768, 768, 3), np.uint8)
    got, want = pack_inputs_yuv(imgs768), jengine.pack_inputs_yuv(imgs768)
    assert got[0].shape == (1, 768, 768) and got[1].shape == (1, 128, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # yuv444 at factor 4 (1024²), where cv2's INTER_AREA is not the block
    # mean: the reconstruction is still exact
    img = _smooth_frames(6, 1, 1024)
    y, cb, cr, gres = pack_inputs_yuv444(img)
    assert ((cb > 0) & (cb < 255) & (cr > 0) & (cr < 255)).all()
    rec = reconstruct_comp_yuv444(*map(torch.from_numpy, (y, cb, cr, gres))).numpy()
    np.testing.assert_array_equal(rec[0], pack_inputs(img)[0][0].astype(np.float32))


# -- device halves ---------------------------------------------------------------------


def test_reconstruct_comp_yuv444_matches_jax_and_pack_inputs(frames) -> None:
    comp = pack_inputs(frames)[0].astype(np.float32)
    y, cb, cr, gres = pack_inputs_yuv444(frames)
    rec = reconstruct_comp_yuv444(*map(torch.from_numpy, (y, cb, cr, gres)))
    assert rec.dtype == torch.float32 and rec.shape == (4, 256, 256, 3)
    rec = rec.numpy()
    np.testing.assert_array_equal(rec, np.asarray(jax.jit(jengine.reconstruct_comp_yuv444)(y, cb, cr, gres)))
    unclipped = (cb > 0) & (cb < 255) & (cr > 0) & (cr < 255)
    assert unclipped[2:].all() and not unclipped[:2].all()  # the fixture has both kinds
    np.testing.assert_array_equal(rec[unclipped], comp[unclipped])
    np.testing.assert_array_equal(rec[2:], comp[2:])


def test_reconstruct_comp_yuv444_any_bytes_match_jax() -> None:
    """Uniform random planes drive the numerators negative, where floor and
    truncating division part: the int32 arithmetic equals the JAX one."""
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (2, 512, 512), np.uint8)
    y[1] //= 8  # dark luma under strong chroma: n < 0
    cb, cr = (rng.integers(0, 256, (2, 256, 256), np.uint8) for _ in range(2))
    gres = rng.integers(0, 256, (2, 256, 128), np.uint8)
    got = reconstruct_comp_yuv444(*map(torch.from_numpy, (y, cb, cr, gres))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jengine.reconstruct_comp_yuv444)(y, cb, cr, gres)))


class _CompEcho:
    """A JAX extractor stub whose logits carry the segmentation input it
    was given: the three channels, back in gray levels, packed into one
    float32 (exact below 2²⁴)."""

    def apply(self, variables, x, **kw):
        c = jnp.round(x * 255.0)
        return (c[..., 0] + 256.0 * c[..., 1] + 65536.0 * c[..., 2])[..., None]


def _jax_run_yuv_comp(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The (B, 256, 256, 3) segmentation input that the JAX package's
    ``Engine.run_yuv`` reconstructs from these planes."""
    ref = jengine.Engine(_CompEcho(), {}, JaxStub(_start_position_logits(), "classifier"), {}, refine_grid="off")
    packed = np.asarray(ref.run_yuv(y, cb, cr)["logits"]).astype(np.int64)
    return np.stack([packed % 256, packed // 256 % 256, packed // 65536], -1).astype(np.float32)


def test_reconstruct_comp_yuv_close_to_exact_and_to_jax() -> None:
    # piecewise-smooth color, like a photo's chroma: a 4×4 base, bilinearly enlarged
    base = np.random.default_rng(3).integers(0, 256, (2, 4, 4, 3), np.uint8)
    imgs = np.asarray(jax_resize(jnp.asarray(base), (512, 512), round_uint8=True))
    comp_exact = pack_inputs(imgs)[0].astype(np.float64)
    y, cb, cr = pack_inputs_yuv(imgs)
    got = reconstruct_comp_yuv(*map(torch.from_numpy, (y, cb, cr))).numpy()
    want = _jax_run_yuv_comp(y, cb, cr)
    assert want.shape == got.shape == (2, 256, 256, 3) and want.max() > 128
    # float32 sums in another order may move a value across a rounding
    # boundary: at most 1 gray level, on under 0.1% of values
    diff = np.abs(got - want)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    err = np.abs(got - comp_exact)
    assert err.mean() < 1.5 and np.percentile(err, 99) <= 6.0


# -- engine entry points ---------------------------------------------------------------


@pytest.mark.parametrize("extractor", ["stub", "yoloseg8"])
def test_run_packed_and_yuv444_bit_identical_to_process_batch(frames, extractor) -> None:
    eng = _stub_engine(extractor)
    imgs = frames[2:3]  # limited chroma: nothing clips in yuv444
    full = eng.process_batch(imgs)
    raw = {k: v.numpy() for k, v in eng.run_device(imgs).items()}
    packed = {k: v.numpy() for k, v in eng.run_packed(*pack_inputs(imgs)).items()}
    y444 = {k: v.numpy() for k, v in eng.run_yuv444(*pack_inputs_yuv444(imgs)).items()}
    assert set(raw) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(packed[k], raw[k], err_msg=k)
        np.testing.assert_array_equal(y444[k], raw[k], err_msg=k)
    if extractor == "stub":
        assert raw["found"].all()
    np.testing.assert_array_equal(raw["found"], full.board_found)
    np.testing.assert_array_equal(raw["quadrangle"], full.quadrangle)
    np.testing.assert_array_equal(raw["board_image"], full.board_image)
    np.testing.assert_array_equal(raw["probabilities"], full.probabilities)
    np.testing.assert_array_equal(raw["logits"], full.logits)


def test_run_yuv_keeps_geometry(frames) -> None:
    """The warp half sees the exact luma: with the mask given, found flags,
    quads, boards and probabilities are those of the raw path, and those of
    the JAX engine's ``run_yuv`` on the same planes."""
    eng, ref = _engines(_quad_logits(STUB_QUAD), _start_position_logits())
    imgs = frames[:1]
    full = eng.process_batch(imgs)
    planes = pack_inputs_yuv(imgs)
    out = {k: v.numpy() for k, v in eng.run_yuv(*planes).items()}
    assert out["found"].all()
    np.testing.assert_array_equal(out["quadrangle"], full.quadrangle)
    np.testing.assert_array_equal(out["board_image"], full.board_image)
    np.testing.assert_array_equal(out["probabilities"], full.probabilities)
    _assert_same_device_outputs(out, ref.run_yuv(*planes))


def _assert_same_device_outputs(got: dict[str, np.ndarray], want: dict) -> None:
    """The port's device outputs against the JAX engine's, at the
    tolerances of the engine tests: quads 1e-3 px, probabilities 1e-5,
    boards within 1 gray level on under 0.1% of pixels (the two frameworks
    round the float32 homography differently in the last bits)."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want) == set(KEYS)
    np.testing.assert_array_equal(got["found"], want["found"])
    np.testing.assert_array_equal(got["logits"], want["logits"])
    np.testing.assert_allclose(got["quadrangle"], want["quadrangle"], atol=1e-3)
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=1e-5)
    assert got["board_image"].dtype == want["board_image"].dtype == np.uint8
    diff = np.abs(got["board_image"].astype(int) - want["board_image"].astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("kind", ["packed", "yuv444"])
def test_run_packed_and_yuv444_match_the_jax_engine(frames, kind) -> None:
    """One frame, host-packed once, through both engines on the stub models."""
    eng, ref = _engines(_quad_logits(STUB_QUAD), _start_position_logits())
    packed = {"packed": pack_inputs, "yuv444": pack_inputs_yuv444}[kind](frames[3:4])
    run = {"packed": "run_packed", "yuv444": "run_yuv444"}[kind]
    got = {k: v.numpy() for k, v in getattr(eng, run)(*packed).items()}
    assert got["found"].all()
    _assert_same_device_outputs(got, getattr(ref, run)(*packed))


# -- run_stream ------------------------------------------------------------------------------

STREAM_KINDS = {"raw": lambda f: f, "packed": pack_inputs, "yuv": pack_inputs_yuv, "yuv444": pack_inputs_yuv444}


@pytest.fixture(scope="module")
def stream_case() -> tuple[Engine, list[np.ndarray]]:
    """256² frames (block factor 1) keep each batch short on the CPU."""
    return _stub_engine("yoloseg8"), [_smooth_frames(20 + i, 1, 256) for i in range(3)]


@pytest.mark.parametrize("kind", list(STREAM_KINDS))
def test_run_stream_yields_the_unstreamed_outputs_in_order(stream_case, kind) -> None:
    eng, batches = stream_case
    pack = STREAM_KINDS[kind]
    run = {"raw": eng.run_device, "packed": eng.run_packed, "yuv": eng.run_yuv, "yuv444": eng.run_yuv444}[kind]
    want = [run(*((pack(b),) if kind == "raw" else pack(b))) for b in batches]
    got = list(eng.run_stream((pack(b) for b in batches), kind=kind))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(KEYS)
        for k in KEYS:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), err_msg=f"{kind} {k}")
    # the three batches differ, so a wrong order could not pass
    assert not np.array_equal(want[0]["board_image"].numpy(), want[1]["board_image"].numpy())
    (only,) = list(eng.run_stream(iter([pack(batches[1])]), kind=kind))
    np.testing.assert_array_equal(only["board_image"].numpy(), want[1]["board_image"].numpy())
    assert list(eng.run_stream(iter([]), kind=kind)) == []


def test_run_stream_order_of_steps_and_unknown_kind(stream_case) -> None:
    """Batch i is dispatched before batch i+1 is drawn from the iterator,
    and batch i+1 is drawn before batch i's outputs are yielded."""
    eng = _stub_engine()
    log: list[str] = []

    def batches():
        for i in range(3):
            log.append(f"draw {i}")
            yield np.full((1, 8, 8, 3), i, np.uint8)

    def fake_run(images, threshold):
        log.append(f"dispatch {int(images[0, 0, 0, 0])} thr={threshold}")
        return {"i": int(images[0, 0, 0, 0])}

    eng._run_device = fake_run  # the raw kind runs the mesh-free path
    for out in eng.run_stream(batches(), threshold=0.25):
        log.append(f"yield {out['i']}")
    assert log == [
        "draw 0", "dispatch 0 thr=0.25", "draw 1", "yield 0",
        "dispatch 1 thr=0.25", "draw 2", "yield 1",
        "dispatch 2 thr=0.25", "yield 2",
    ]  # fmt: skip
    with pytest.raises(ValueError, match="unknown stream kind"):
        next(eng.run_stream(iter([]), kind="jpeg"))


# -- resize ranks ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 48), (64, 48, 3), (3, 64, 48), (2, 64, 48, 3)], ids=str)
@pytest.mark.parametrize("dst", [(32, 24), (40, 100), (128, 96)], ids=str)
def test_resize_takes_the_four_ranks(shape, dst) -> None:
    img = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_resize(jnp.asarray(img), dst))
    got = resize(torch.from_numpy(img), dst)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # (32, 24) is the exact integer-factor path; the others are two float32
    # contractions in another summation order: a few ulp of 255
    np.testing.assert_allclose(got.numpy(), want, atol=0 if dst == (32, 24) else 1e-4)
    want_u8 = np.asarray(jax_resize(jnp.asarray(img), dst, round_uint8=True))
    got_u8 = resize(torch.from_numpy(img), dst, round_uint8=True)
    assert got_u8.dtype == torch.uint8
    if dst == (40, 100):
        # fractional box weights put sums within an ulp of a .5 boundary:
        # 1 gray level on under 0.1% of values
        diff = np.abs(got_u8.numpy().astype(int) - want_u8.astype(int))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    else:
        np.testing.assert_array_equal(got_u8.numpy(), want_u8)
