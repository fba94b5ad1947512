"""Parity of the PyTorch port's image ops with the JAX package, on the CPU.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its ``chessvision_tpu_torch`` counterpart on
``device="cpu"``.  Tolerances: integer stages (gray, area resize, quad
corners and ``found``, grid detection, the bf16 correction resample) are
bit-exact; float stages state theirs beside the assertion.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.ops import color as jcolor
from chessvision_tpu.ops import gridfix as jgridfix
from chessvision_tpu.ops import quad as jquad
from chessvision_tpu.ops import squares as jsquares
from chessvision_tpu.ops import warp as jwarp
from chessvision_tpu.ops.pallas_kernels import banded_resample
from chessvision_tpu_torch.ops import color, gridfix, hat_resample, quad, squares, warp
from chessvision_tpu_torch.synthetic import board_frames
from tests._quad_cases import masks as _masks

# the ops packages re-export the function ``resize`` under the module's name
jresize = importlib.import_module("chessvision_tpu.ops.resize")
resize = importlib.import_module("chessvision_tpu_torch.ops.resize")

_DEST = np.array([[0, 0], [512, 0], [512, 512], [0, 512]], np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def frames() -> tuple[np.ndarray, np.ndarray]:
    return board_frames(seed=11, n=2)


# -- color / resize / squares --------------------------------------------------


def test_bgr_to_gray_bit_exact() -> None:
    img = np.random.default_rng(0).integers(0, 256, (2, 64, 48, 3), np.uint8)
    want = np.asarray(jcolor.bgr_to_gray(jnp.asarray(img), exact_u8=True))
    got = color.bgr_to_gray(_t(img), exact_u8=True).numpy()
    np.testing.assert_array_equal(got, want)
    # float path: three products and two sums, ≤ 1 ulp apart
    want_f = np.asarray(jcolor.bgr_to_gray(jnp.asarray(img, jnp.float32)))
    np.testing.assert_allclose(color.bgr_to_gray(_t(img).float()).numpy(), want_f, atol=1e-4)


def test_hflip_matches() -> None:
    a = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    np.testing.assert_array_equal(color.hflip(_t(a)).numpy(), np.asarray(jcolor.hflip(jnp.asarray(a))))
    c = np.arange(5 * 6 * 3, dtype=np.float32).reshape(5, 6, 3)
    np.testing.assert_array_equal(color.hflip(_t(c)).numpy(), np.asarray(jcolor.hflip(jnp.asarray(c))))


@pytest.mark.parametrize("factor", [2, 4])
def test_resize_fast_path_bit_exact(frames, factor) -> None:
    """512→256 (the main path) and 1024→256: power-of-two boxes."""
    imgs = frames[0] if factor == 2 else np.tile(frames[0], (1, 2, 2, 1))
    want = np.asarray(jresize.resize(jnp.asarray(imgs), (256, 256), round_uint8=True))
    got = resize.resize(_t(imgs), (256, 256), round_uint8=True).numpy()
    np.testing.assert_array_equal(got, want)
    want_f = np.asarray(jresize.resize(jnp.asarray(imgs), (256, 256)))
    np.testing.assert_array_equal(resize.resize(_t(imgs), (256, 256)).numpy(), want_f)


@pytest.mark.parametrize("src_hw,dst_hw", [((96, 96), (64, 64)), ((48, 40), (64, 80)), ((60, 90), (20, 30))])
def test_resize_matmul_path(src_hw, dst_hw) -> None:
    img = np.random.default_rng(1).integers(0, 256, (2, *src_hw, 3), np.uint8)
    for m_t, m_j in zip(resize.resize_matrices(*src_hw, *dst_hw), jresize.resize_matrices(*src_hw, *dst_hw)):
        np.testing.assert_array_equal(m_t, m_j)
    want = np.asarray(jresize.resize(jnp.asarray(img), dst_hw))
    got = resize.resize(_t(img), dst_hw).numpy()
    # two float32 contractions in another summation order: ≤ a few ulp of 255
    np.testing.assert_allclose(got, want, atol=1e-4)
    want_u8 = np.asarray(jresize.resize(jnp.asarray(img), dst_hw, round_uint8=True))
    got_u8 = resize.resize(_t(img), dst_hw, round_uint8=True).numpy()
    np.testing.assert_array_equal(got_u8, want_u8)


def test_extract_squares_matches() -> None:
    boards = np.random.default_rng(2).random((2, 512, 512)).astype(np.float32)
    want = np.asarray(jsquares.extract_squares_batch(jnp.asarray(boards)))
    np.testing.assert_array_equal(squares.extract_squares_batch(_t(boards)).numpy(), want)


# -- K1: the hat resample --------------------------------------------------------


def _k1_case(name: str) -> tuple[np.ndarray, np.ndarray]:
    """The three cases of tests/test_pallas_kernels.py."""
    if name == "in_range":
        src = np.random.default_rng(0).random((32, 512)).astype(np.float32)
        base = np.linspace(10, 10 + 511 * 0.9, 512)
        pos = np.stack([base + i for i in range(32)]).astype(np.float32)
    elif name == "borders":
        src = np.random.default_rng(1).random((32, 512)).astype(np.float32)
        pos = np.stack([np.linspace(-3, 514, 512) + 0.3 * i for i in range(32)]).astype(np.float32)
    else:  # upscale
        src = np.random.default_rng(2).random((32, 512)).astype(np.float32)
        pos = np.stack([200 + np.linspace(0, 100, 512)] * 32).astype(np.float32)
    return src, pos


@pytest.mark.parametrize("reference", ["last_axis", "banded_wide", "banded_narrow"])
@pytest.mark.parametrize("case", ["in_range", "borders", "upscale"])
def test_hat_resample_plain_matches_jax(case, reference) -> None:
    src, pos = _k1_case(case)
    if reference == "last_axis":
        want = np.asarray(jwarp._hat_resample_last_axis(jnp.asarray(src), jnp.asarray(pos)))
    else:
        cfg = reference.split("_")[1]
        want = np.asarray(banded_resample(jnp.asarray(src), jnp.asarray(pos), interpret=True, config=cfg))
    got = hat_resample.hat_resample_plain(_t(src), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_hat_resample_dispatch_cpu_is_plain() -> None:
    src, pos = _k1_case("borders")
    before = hat_resample.launches
    got = hat_resample.hat_resample(_t(src), _t(pos))
    assert hat_resample.launches == before
    np.testing.assert_array_equal(got.numpy(), hat_resample.hat_resample_plain(_t(src), _t(pos)).numpy())
    with pytest.raises(ValueError):
        hat_resample.hat_resample(torch.zeros(2, 8, device="meta"), torch.zeros(2, 8, device="meta"))


# -- homography and warps ---------------------------------------------------------


def test_homography_matches(frames) -> None:
    quads = frames[1]
    want = np.stack([np.asarray(jwarp.get_perspective_transform(jnp.asarray(q), jnp.asarray(_DEST))) for q in quads])
    got = warp.get_perspective_transform(_t(quads), _t(_DEST).expand(2, 4, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    want_inv = np.stack([np.asarray(jwarp.invert_homography(jnp.asarray(m))) for m in want])
    np.testing.assert_allclose(warp.invert_homography(_t(want)).numpy(), want_inv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_px,margin", [(576, 32), (512, 0)])
def test_twopass_warp_matches(frames, out_px, margin) -> None:
    imgs, quads = frames
    gray = np.asarray(jcolor.bgr_to_gray(jnp.asarray(imgs), exact_u8=True)).astype(np.float32)
    ms = np.stack(
        [np.asarray(jwarp.get_perspective_transform(jnp.asarray(q), jnp.asarray(_DEST + margin))) for q in quads]
    )
    want = np.asarray(jwarp._warp_batched_twopass(jnp.asarray(gray), jnp.asarray(ms), out_px, out_px))
    got = warp.warp_perspective(_t(gray), _t(ms), (out_px, out_px)).numpy()
    assert got.shape == want.shape == (2, out_px, out_px)
    # same homographies and the same hat resample: float32 position math
    # differs by at most a few ulp, which moves a gray value ≪ 0.05
    np.testing.assert_allclose(got, want, atol=0.05)
    same = np.mean(np.floor(got + 0.5) == np.floor(want + 0.5))
    assert same >= 0.999, same


def test_bilinear_warp_matches(frames) -> None:
    imgs, quads = frames
    gray = np.asarray(jcolor.bgr_to_gray(jnp.asarray(imgs), exact_u8=True)).astype(np.float32)
    ms = np.stack([np.asarray(jwarp.get_perspective_transform(jnp.asarray(q), jnp.asarray(_DEST))) for q in quads])
    want = np.asarray(jwarp.warp_perspective(jnp.asarray(gray), jnp.asarray(ms), (512, 512), method="bilinear"))
    got = warp.warp_perspective(_t(gray), _t(ms), (512, 512), method="bilinear").numpy()
    np.testing.assert_allclose(got, want, atol=0.05)


# -- quadrangles ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_probs(frames) -> np.ndarray:
    """Soft probability maps from the committed UNet (float32, CPU) on the
    synthetic frames: the masks the main path really sees."""
    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch.core import build_model
    from chessvision_tpu_torch.engine import preprocess_images

    ex, _ = build_model("extractor", None, constants.BEST_EXTRACTOR_WEIGHTS, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        comp, _ = preprocess_images(_t(frames[0]))
        return torch.sigmoid(ex(comp.float() / 255.0)[..., 0]).numpy()


@pytest.mark.parametrize("name", sorted(_masks()))
def test_quadrangle_identical(name) -> None:
    probs = _masks()[name][None]
    want_q, want_f = jquad.find_quadrangle_batch(jnp.asarray(probs), 0.5)
    got_q, got_f = quad.find_quadrangle_batch(_t(probs), 0.5)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_quadrangle_identical_on_unet_maps(unet_probs) -> None:
    want_q, want_f = jquad.find_quadrangle_batch(jnp.asarray(unet_probs), 0.5)
    got_q, got_f = quad.find_quadrangle_batch(_t(unet_probs), 0.5)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    want_s = np.asarray(jquad.scale_quadrangle(want_q, 512.0))
    np.testing.assert_array_equal(quad.scale_quadrangle(got_q, 512.0).numpy(), want_s)


# -- grid refinement ----------------------------------------------------------------


@pytest.fixture(scope="module")
def rounded_boards(frames) -> tuple[np.ndarray, np.ndarray]:
    """Margin canvases (576²) of the synthetic frames, warped by the JAX
    package, and their uint8-rounded interiors."""
    imgs, quads = frames
    gray = np.asarray(jcolor.bgr_to_gray(jnp.asarray(imgs), exact_u8=True)).astype(np.float32)
    # quads shrunk/grown a little so the detected grid is not the identity
    quads = quads + np.array([[6, 4], [-5, 7], [-6, -3], [4, -6]], np.float32)
    ms = np.stack(
        [np.asarray(jwarp.get_perspective_transform(jnp.asarray(q), jnp.asarray(_DEST + 32))) for q in quads]
    )
    wide = np.asarray(jwarp._warp_batched_twopass(jnp.asarray(gray), jnp.asarray(ms), 576, 576))
    rounded = np.clip(np.floor(wide[:, 32:544, 32:544] + 0.5), 0, 255)
    return wide, rounded


def test_detect_grid_identical(rounded_boards) -> None:
    _, rounded = rounded_boards
    want = np.asarray(jgridfix.detect_grid(jnp.asarray(rounded)))
    got = gridfix.detect_grid(_t(rounded)).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_correction_bit_exact(rounded_boards) -> None:
    wide, rounded = rounded_boards
    corr = np.asarray(jgridfix.detect_grid(jnp.asarray(rounded)))
    corr = np.concatenate([corr, [[-3.0, 65.0, 2.0, 63.5]]]).astype(np.float32)
    wide = np.concatenate([wide, wide[:1]])
    want = np.asarray(jgridfix.apply_correction(jnp.asarray(wide), jnp.asarray(corr), margin=32))
    got = gridfix.apply_correction(_t(wide), _t(corr), margin=32).numpy()
    np.testing.assert_array_equal(got, want)


def test_refined_quadrangle_close(frames) -> None:
    ms = np.stack([np.asarray(jwarp.get_perspective_transform(jnp.asarray(q), jnp.asarray(_DEST))) for q in frames[1]])
    corr = np.array([[-3.0, 65.0, 2.0, 63.5], [0.0, 64.0, 0.0, 64.0]], np.float32)
    want = np.asarray(jgridfix.refined_quadrangle(jnp.asarray(ms), jnp.asarray(corr)))
    got = gridfix.refined_quadrangle(_t(ms), _t(corr)).numpy()
    # float32 3×3 algebra in another order: ≤ 1e-3 px
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_median_averages_the_two_middle_values() -> None:
    x = np.random.default_rng(5).random((3, 512)).astype(np.float32)
    np.testing.assert_array_equal(
        gridfix._median(_t(x)).numpy(), np.asarray(jnp.median(jnp.asarray(x), axis=-1, keepdims=True))
    )
