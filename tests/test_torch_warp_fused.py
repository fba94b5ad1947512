"""The two-pass warp entry of K1 (``hat_resample.warp_twopass``) on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
``_warp_batched_twopass`` and the port's ``warp_twopass`` on CPU tensors
(where the wrapper takes the tap gather ``warp_fused_plain``).  Tolerance:
0 everywhere.
Given the same homography, both frameworks round every ``*``, ``+``,
``-`` and ``/`` of the position math to nearest, one operation at a time
(JAX dispatches this function op by op here), and the hat resample sums
at most two nonzero terms, so the floats are equal.  The wrapper equals
the dense plain version ``warp_twopass_plain`` here, which
``tests/test_torch_warp_route.py`` holds against JAX at the main path's
shape and the card's kernels are held against in
``tests/test_torch_cuda.py``.  On non-finite inputs the wrapper follows
the card's tap rule, not JAX's dense form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.ops import warp as jwarp
from chessvision_tpu_torch.ops import hat_resample, warp
# by its own name, as the card's file imports it
from _warp_cases import BAD_PIXEL, CANVAS, NONFINITE, nonfinite_case, taps_pixel

_DEST = np.array([[0, 0], [512, 0], [512, 512], [0, 512]], np.float32)
_SIZES = [(576, 32), (512, 0)]  # (canvas side, margin): the main path's two shapes


def _rotated_quad(deg: float, side: float, center: tuple[float, float]) -> np.ndarray:
    a = np.deg2rad(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * side / 2
    return (corners @ rot.T + np.asarray(center)).astype(np.float32)


_QUADS = {
    "rotated_plus_30": _rotated_quad(30.0, 300.0, (256.0, 256.0)),
    "rotated_minus_30": _rotated_quad(-30.0, 340.0, (240.0, 270.0)),
    "partly_outside": _rotated_quad(8.0, 420.0, (400.0, 380.0)),  # two corners beyond 512
}


def _inputs(names: list[str], margin: int, size: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Seeded gray images (B, size, size) and src→dst homographies (B, 3, 3)."""
    rng = np.random.default_rng(len(names) * 100 + margin)
    imgs = rng.integers(0, 256, (len(names), size, size)).astype(np.float32)
    ms = np.stack(
        [np.asarray(jwarp.get_perspective_transform(jnp.asarray(_QUADS[n]), jnp.asarray(_DEST + margin))) for n in names]
    )
    return imgs, ms


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _positions_numpy(minv: np.ndarray, src_h: int, out_h: int, out_w: int) -> tuple[np.ndarray, np.ndarray]:
    """chessvision_tpu/ops/warp.py's position math in numpy float32, one
    rounded operation at a time."""
    assert minv.dtype == np.float32
    (a, b, c), (d, e, f), (g, h, i) = (
        [minv[:, r, k][:, None, None] for k in range(3)] for r in range(3)
    )
    eps = np.float32(1e-8)

    def guard(den: np.ndarray) -> np.ndarray:
        return np.where(np.abs(den) < eps, eps, den)

    ys = np.broadcast_to(np.arange(src_h, dtype=np.float32)[:, None], (src_h, out_w))
    us = np.broadcast_to(np.arange(out_w, dtype=np.float32)[None, :], (src_h, out_w))
    den_v = e - ys * h
    v_star = (ys * (g * us + i) - d * us - f) / guard(den_v)
    den_x = g * us + h * v_star + i
    hx = (a * us + b * v_star + c) / guard(den_x)
    vs = np.broadcast_to(np.arange(out_h, dtype=np.float32)[None, :], (out_w, out_h))
    uu = np.broadcast_to(np.arange(out_w, dtype=np.float32)[:, None], (out_w, out_h))
    den = g * uu + h * vs + i
    vy = (d * uu + e * vs + f) / guard(den)
    assert hx.dtype == vy.dtype == np.float32
    return hx, vy


@pytest.mark.parametrize("out_px,margin", _SIZES)
@pytest.mark.parametrize("name", sorted(_QUADS))
def test_twopass_positions_equal_numpy_float32(name, out_px, margin) -> None:
    _, ms = _inputs([name], margin)
    minv = np.asarray(jax.vmap(jwarp.invert_homography)(jnp.asarray(ms)))
    want_hx, want_vy = _positions_numpy(minv, 512, out_px, out_px)
    hx, vy = hat_resample.twopass_positions(_t(minv), 512, out_px, out_px)
    assert hx.shape == (1, 512, out_px) and vy.shape == (1, out_px, out_px)
    np.testing.assert_array_equal(hx.numpy(), want_hx)  # tolerance 0
    np.testing.assert_array_equal(vy.numpy(), want_vy)


def test_twopass_positions_guard_small_denominators() -> None:
    """e − y·h = 0 on source row 256 and g·u + h·v + i = 0 at (u, v) = (0, 0):
    both denominators take the 1e-8 guard, as in the numpy derivation."""
    minv = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0 / 256.0, 0.0]]], np.float32)
    want_hx, want_vy = _positions_numpy(minv, 512, 16, 16)
    hx, vy = hat_resample.twopass_positions(_t(minv), 512, 16, 16)
    np.testing.assert_array_equal(hx.numpy(), want_hx)
    np.testing.assert_array_equal(vy.numpy(), want_vy)
    assert np.isfinite(want_hx[0, 256]).all() and np.isfinite(want_vy[0, 0, 0])


@pytest.mark.parametrize("out_px,margin", _SIZES)
@pytest.mark.parametrize("names", [["rotated_plus_30"], ["partly_outside"], sorted(_QUADS)], ids=["b1_rotated", "b1_outside", "b3"])
def test_warp_twopass_cpu_equals_jax(names, out_px, margin) -> None:
    imgs, ms = _inputs(names, margin)
    want = np.asarray(jwarp._warp_batched_twopass(jnp.asarray(imgs), jnp.asarray(ms), out_px, out_px))
    minv = warp.invert_homography(_t(ms))
    got = hat_resample.warp_twopass(_t(imgs), minv, out_px, out_px)
    assert got.shape == want.shape == (len(names), out_px, out_px)
    np.testing.assert_array_equal(got.numpy(), want)  # tolerance 0
    # the public function takes the same route
    via = warp.warp_perspective(_t(imgs), _t(ms), (out_px, out_px))
    np.testing.assert_array_equal(via.numpy(), want)
    if "partly_outside" in names:  # the zero border was exercised
        assert (want[names.index("partly_outside")] == 0).mean() > 0.05


def test_warp_twopass_cpu_is_plain() -> None:
    """CPU tensors take the tap gather ``warp_fused_plain`` (K1's tap rule,
    as both card routes compute it) in ``warp_twopass_plain``'s strides; on
    finite inputs its floats are the dense form's."""
    imgs, ms = _inputs(["rotated_minus_30", "partly_outside"], 32, size=96)
    minv = warp.invert_homography(_t(ms))
    before = hat_resample.launches
    got = hat_resample.warp_twopass(_t(imgs), minv, 80, 72)
    assert hat_resample.launches == before  # no kernel on CPU tensors
    assert got.shape == (2, 80, 72)
    np.testing.assert_array_equal(got.numpy(), hat_resample.warp_fused_plain(_t(imgs), minv, 80, 72).numpy())
    want = hat_resample.warp_twopass_plain(_t(imgs), minv, 80, 72)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.stride() == want.stride() == (80 * 72, 1, 80)
    assert warp.warp_twopass_plain is hat_resample.warp_twopass_plain
    assert warp.twopass_positions is hat_resample.twopass_positions


@pytest.mark.parametrize("case", NONFINITE)
def test_warp_twopass_cpu_follows_the_tap_rule_on_nonfinite_inputs(case) -> None:
    """Where a position or a pixel is not finite, the CPU gives what the
    card's kernels give: 0 where no tap lies inside the frame (a NaN or
    infinite position), and non-finite values only at the outputs that
    read a bad pixel.  The dense form spreads NaN over the whole board,
    since 0 · inf is NaN.  The batch's second board is untouched."""
    imgs, minv = nonfinite_case(case)
    got = hat_resample.warp_twopass(imgs, minv, CANVAS, CANVAS)
    dense = hat_resample.warp_twopass_plain(imgs, minv, CANVAS, CANVAS)
    np.testing.assert_array_equal(got[1].numpy(), dense[1].numpy())
    assert bool(torch.isfinite(got[1]).all()) and float(got[1].max()) > 0
    if case != "inf_pixel":
        assert bool((got[0] == 0).all())
        return
    hit = taps_pixel(minv, CANVAS, CANVAS, BAD_PIXEL)[0]
    assert hit.any()
    np.testing.assert_array_equal(~np.isfinite(got[0].numpy()), hit)
    clean = imgs.clone()
    clean[0][BAD_PIXEL] = 0.0
    np.testing.assert_array_equal(got[0].numpy()[~hit], hat_resample.warp_twopass_plain(clean, minv, CANVAS, CANVAS)[0].numpy()[~hit])


def test_warp_twopass_plain_is_two_hat_resamples() -> None:
    imgs, ms = _inputs(["rotated_plus_30"], 0, size=64)
    minv = warp.invert_homography(_t(ms))
    hx, vy = hat_resample.twopass_positions(minv, 64, 48, 40)
    tmp = hat_resample.hat_resample(_t(imgs), hx)
    want = hat_resample.hat_resample(tmp.transpose(1, 2), vy).transpose(1, 2)
    got = hat_resample.warp_twopass_plain(_t(imgs), minv, 48, 40)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize(
    "case,error",
    [("float64_imgs", TypeError), ("float64_minv", TypeError), ("batch_mismatch", ValueError),
     ("not_batched", ValueError), ("unsupported_device", ValueError)],
)
def test_warp_twopass_rejects(case, error) -> None:
    imgs = torch.zeros(2, 16, 16)
    minv = torch.eye(3).expand(2, 3, 3).contiguous()
    if case == "float64_imgs":
        imgs = imgs.double()
    elif case == "float64_minv":
        minv = minv.double()
    elif case == "batch_mismatch":
        minv = minv[:1]
    elif case == "not_batched":
        imgs, minv = imgs[0], minv[0]
    else:
        imgs, minv = imgs.to("meta"), minv.to("meta")
    with pytest.raises(error):
        hat_resample.warp_twopass(imgs, minv, 16, 16)
