"""K1's two routes (``hat_resample.warp_plan``) on the CPU.

On the card ``warp_twopass`` takes the fused route, one kernel that
computes each canvas pixel from the four source floats it depends on,
where the warp shrinks the frame (camera photos), and the two-pass route
elsewhere.  A CUDA kernel does not run here, so this file holds the fused
route's order of operations, ``warp_fused_plain``, against the two-pass
plain version and against the JAX package's ``_warp_batched_twopass`` on
the same numpy inputs made from a seed, at tolerance 0: both round every
operation of the position math to nearest one at a time, and each hat sum
has at most two nonzero terms, which the fused order sums alike.  Frames
of 480×640 and 641×479 into a 64² canvas shrink 7.5–10× as camera photos
into the 576² canvas do, at a size the dense form ``warp_twopass_plain``
can afford (a 512² frame into the 576² canvas costs ~0.03 s by the tap
gather that CPU tensors take, 1.4–2.2 s by the dense form); one case
holds the main path's shape, two 512² frames into the 576² canvas.  The fused kernel itself is held
against ``warp_twopass_plain`` on the card in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.ops import warp as jwarp
from chessvision_tpu_torch.ops import hat_resample, warp
from chessvision_tpu_torch.synthetic import photo_frames
from chessvision_tpu_torch.tools import flops, microbench

CANVAS, MARGIN = 64, 4
SIZES = [(480, 640), (641, 479)]
QUADS = ["photo", "photo_x_by_height", "rotated_plus_30", "rotated_minus_25", "partly_outside"]
# the main path's shape: two 512² frames into the 576² canvas, margin 32
MAIN, MAIN_CANVAS, MAIN_MARGIN = (512, 512), 576, 32
CASES = [(hw, quad) for hw in SIZES for quad in QUADS] + [(MAIN, "main_path")]


def _rotated(deg: float, side: float, cx: float, cy: float) -> np.ndarray:
    a = np.deg2rad(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * side / 2 @ rot.T + [cx, cy]


def _inputs(hw: tuple[int, int], quad: str) -> tuple[np.ndarray, np.ndarray]:
    """A seeded gray photo (1, h, w) float32 and the src→dst homography
    (1, 3, 3) that takes ``quad`` onto the canvas's board; for
    ``"main_path"`` two frames (2, 512, 512), their boards' quads onto the
    576² canvas."""
    h, w = hw
    if quad == "main_path":
        frames, quads = photo_frames(h + w, 2, h, w)
        dest = np.array([[0, 0], [512, 0], [512, 512], [0, 512]], np.float32) + MAIN_MARGIN
        ms = [np.array(jwarp.get_perspective_transform(jnp.asarray(q, jnp.float32), jnp.asarray(dest))) for q in quads]
        return frames[..., 1].astype(np.float32), np.stack(ms)
    frames, quads = photo_frames(h + w + QUADS.index(quad), 1, h, w)
    gray = frames[..., 1].astype(np.float32)  # any plane: the warp is per plane
    q = quads[0].astype(np.float64)
    if quad == "photo_x_by_height":  # the engine's quad: x scaled by the height (the reference quirk)
        q[:, 0] *= h / w
    elif quad == "rotated_plus_30":
        q = _rotated(30, 0.5 * min(h, w), 0.5 * w, 0.5 * h)
    elif quad == "rotated_minus_25":
        q = _rotated(-25, 0.45 * min(h, w), 0.4 * w, 0.6 * h)
    elif quad == "partly_outside":  # two corners past the frame: K1's zero border
        q = _rotated(6, 0.7 * min(h, w), 0.85 * w, 0.8 * h)
    dest = np.array([[0, 0], [CANVAS, 0], [CANVAS, CANVAS], [0, CANVAS]], np.float32)
    dest = dest * (CANVAS - 2 * MARGIN) / CANVAS + MARGIN
    m = np.array(jwarp.get_perspective_transform(jnp.asarray(q, jnp.float32), jnp.asarray(dest)))
    return gray, m[None]


@pytest.mark.parametrize("hw,quad", CASES, ids=[f"{h}x{w}-{quad}" for (h, w), quad in CASES])
def test_fused_plain_equals_twopass_plain_and_jax(hw, quad) -> None:
    imgs, ms = _inputs(hw, quad)
    out = MAIN_CANVAS if quad == "main_path" else CANVAS
    assert hat_resample.warp_plan(len(imgs), *hw, out, out) == ("twopass" if quad == "main_path" else "fused")
    want = np.asarray(jwarp._warp_batched_twopass(jnp.asarray(imgs), jnp.asarray(ms), out, out))
    t_imgs = torch.from_numpy(imgs)
    minv = warp.invert_homography(torch.from_numpy(ms))
    fused = hat_resample.warp_fused_plain(t_imgs, minv, out, out)
    twopass = hat_resample.warp_twopass_plain(t_imgs, minv, out, out)
    assert fused.shape == twopass.shape == want.shape == (len(imgs), out, out)
    np.testing.assert_array_equal(fused.numpy(), twopass.numpy())  # tolerance 0
    np.testing.assert_array_equal(fused.numpy(), want)
    assert want.max() > 0
    if quad == "partly_outside":  # the zero border was exercised
        assert (want == 0).mean() > 0.05


def test_fused_plain_guards_a_zero_denominator() -> None:
    """e − y·h is exactly 0 on source row 256, a row that pass 2 reads (vy
    crosses 256), and g·u + h·v + i is never near 0: pass 1's v* takes the
    1e-8 guard on that row in both orders of operations."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 480, 640)).astype(np.float32))
    m = torch.tensor([[1.0, 0.0, 0.0], [4.0, 1.0, 200.0], [0.0, 1.0 / 256.0, 1.0]])
    minv = torch.stack([m, m * 0.5])
    assert float(m[1, 1] - 256.0 * m[2, 1]) == 0.0
    _, vy = hat_resample.twopass_positions(minv, 480, CANVAS, CANVAS)
    assert bool(((vy >= 255.0) & (vy < 257.0)).any())
    fused = hat_resample.warp_fused_plain(imgs, minv, CANVAS, CANVAS)
    twopass = hat_resample.warp_twopass_plain(imgs, minv, CANVAS, CANVAS)
    np.testing.assert_array_equal(fused.numpy(), twopass.numpy())
    assert bool(torch.isfinite(fused).all()) and float(fused.abs().max()) > 0


# (b, h, w, out_h, out_w): the route the card takes
PLANS = {
    "main_b128": ((128, 512, 512, 576, 576), "twopass"),
    "main_b8": ((8, 512, 512, 576, 576), "twopass"),
    "main_b1": ((1, 512, 512, 576, 576), "twopass"),
    "main_margin_0": ((128, 512, 512, 512, 512), "twopass"),
    "augment_segmentation": ((96, 256, 256, 256, 256), "twopass"),
    "augment_masks": ((32, 256, 256, 256, 256), "twopass"),
    "augment_classifier": ((256, 64, 64, 64, 64), "twopass"),
    "12mp": ((1, 3024, 4032, 576, 576), "fused"),
    "12mp_portrait": ((1, 4032, 3024, 576, 576), "fused"),
    "48mp": ((1, 6048, 8064, 576, 576), "fused"),
    "odd": ((1, 3023, 4031, 576, 576), "fused"),
    "12mp_b4": ((4, 3024, 4032, 576, 576), "fused"),
    "this_file": ((1, 480, 640, CANVAS, CANVAS), "fused"),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_warp_plan_names_the_route(case) -> None:
    shape, route = PLANS[case]
    assert hat_resample.warp_plan(*shape) == route
    assert hat_resample.ROUTE_KERNELS[route] == (("warp_fused",) if route == "fused" else ("warp_pass1", "warp_pass2"))


def test_warp_twopass_on_cpu_is_plain_on_either_route() -> None:
    """CPU tensors take the tap gather ``warp_fused_plain`` whatever the
    route the card would take, and launch nothing; on these finite inputs
    its floats are ``warp_twopass_plain``'s."""
    imgs, ms = _inputs((480, 640), "photo")
    minv = warp.invert_homography(torch.from_numpy(ms))
    before, by_kernel = hat_resample.launches, dict(hat_resample.kernel_launches)
    got = hat_resample.warp_twopass(torch.from_numpy(imgs), minv, CANVAS, CANVAS)
    assert hat_resample.launches == before and hat_resample.kernel_launches == by_kernel
    np.testing.assert_array_equal(got.numpy(), hat_resample.warp_fused_plain(torch.from_numpy(imgs), minv, CANVAS, CANVAS).numpy())
    want = hat_resample.warp_twopass_plain(torch.from_numpy(imgs), minv, CANVAS, CANVAS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_an_empty_batch_launches_nothing() -> None:
    imgs = torch.zeros((0, 480, 640))
    minv = torch.zeros((0, 3, 3))
    before, by_kernel = hat_resample.launches, dict(hat_resample.kernel_launches)
    assert hat_resample.warp_plan(0, 480, 640, CANVAS, CANVAS) == "fused"
    assert hat_resample.warp_twopass(imgs, minv, CANVAS, CANVAS).shape == (0, CANVAS, CANVAS)
    assert hat_resample.warp_fused_plain(imgs, minv, CANVAS, CANVAS).shape == (0, CANVAS, CANVAS)
    assert hat_resample.launches == before and hat_resample.kernel_launches == by_kernel


@pytest.mark.parametrize(
    "case,match",
    [("cpu_tensors", "contiguous CUDA"), ("rows_over_int32", "index limits"), ("batch_over_grid", "index limits")],
)
def test_warp_fused_launcher_refuses(case, match) -> None:
    """The fused route's launcher takes CUDA tensors only, and checks the
    kernel's index limits before anything else (meta tensors hold no
    memory, so the limits are reached here)."""
    if case == "cpu_tensors":
        imgs, minv = torch.zeros((1, 480, 640)), torch.eye(3)[None]
    elif case == "rows_over_int32":
        imgs, minv = torch.empty((1, 46341, 46341), device="meta"), torch.empty((1, 3, 3), device="meta")
    else:
        imgs, minv = torch.empty((65536, 8, 8), device="meta"), torch.empty((65536, 3, 3), device="meta")
    with pytest.raises(ValueError, match=match):
        hat_resample.warp_fused(imgs, minv, CANVAS, CANVAS)


def test_zero_launches_resets_every_count() -> None:
    saved, saved_by = hat_resample.launches, dict(hat_resample.kernel_launches)
    try:
        hat_resample.launches = 5
        hat_resample.kernel_launches["warp_fused"] = 3
        hat_resample.zero_launches()
        assert hat_resample.launches == 0 and not any(hat_resample.kernel_launches.values())
        assert set(hat_resample.kernel_launches) == {k for ks in hat_resample.ROUTE_KERNELS.values() for k in ks} | {
            "hat_resample"}
    finally:
        hat_resample.launches = saved
        hat_resample.kernel_launches.update(saved_by)


def test_the_route_sweep_and_its_inputs() -> None:
    """``microbench --which route``: the shapes it sweeps, its photo inputs
    (made here on the CPU at a small size), and no run without the card."""
    shapes = microbench.route_shapes()
    assert shapes[-1] == (128, 512, 512) and len(shapes) == 13
    assert {(h, w) for _, h, w in shapes} >= {(3024, 4032), (4032, 3024), (6048, 8064)}
    assert [hat_resample.warp_plan(*s, 576, 576) for s in shapes].count("twopass") == 3  # heights 512, and B=128
    imgs, minv = microbench.photo_inputs(2, 480, 640, 0, torch.device("cpu"))
    assert imgs.shape == (2, 480, 640) and minv.shape == (2, 3, 3) and bool(torch.isfinite(minv).all())
    got = hat_resample.warp_fused_plain(imgs, minv, CANVAS, CANVAS)
    np.testing.assert_array_equal(got.numpy(), hat_resample.warp_twopass_plain(imgs, minv, CANVAS, CANVAS).numpy())
    with pytest.raises(ValueError, match="only on the card"):
        microbench.main(["--which", "route", "--device", "cpu"])


def test_row_tap_sector_bytes_counts_each_taps_sector_once() -> None:
    """One pass's floor: the 32-byte sectors of its nonzero taps, through the
    source's strides (pass 2 reads a transposed view), against a count by
    hand over every tap."""
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.random((2, 6, 40)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(-2, 42, (2, 6, 9)).astype(np.float32))
    pos[0, 0, 0] = 3.0  # an integer position: its second tap has weight 0 and is not read
    pos_t = torch.from_numpy(rng.uniform(-2, 8, (2, 40, 5)).astype(np.float32))  # along the 6 rows
    for s, p in ((src, pos), (src.transpose(1, 2), pos_t)):
        want = set()
        for b, r, u in np.ndindex(*p.shape):
            x = float(p[b, r, u])
            for c in (np.floor(x), np.floor(x) + 1):
                if 0 <= c < s.shape[2] and 1.0 - abs(x - c) > 0:
                    off = b * s.stride(0) + r * s.stride(1) + int(c) * s.stride(2)
                    want.add((s.data_ptr() % 32 + 4 * off) // 32)
        assert flops.row_tap_sector_bytes(s, p) == 32 * len(want)
