"""The port's training augmentations, on the CPU (K1's CPU path, the tap
gather ``warp_fused_plain``).

- the contracts of tests/test_augment.py: shapes, ranges, determinism at a
  key, identity matrices are no-ops (exactly), rotation moves content,
  two-pass against bilinear at moderate rotation, cutout / illumination
  gradient / dimming / fade;
- parity at given draws: ``_rotation_matrices``, ``_affine_matrices``,
  ``_warp_nhwc``, the blur, the color jitter and the illumination gradient
  against the JAX helpers fed the same drawn values, 1e-5 (images at 64²
  or smaller: the JAX helpers' dense warp broadcasts (N, H, J, U));
- the draws: integer segmentation angles, and turning one flag on leaves
  every other augmentation's draws unchanged (JAX's PRNG is not
  reproduced; the port draws each quantity from its own generator).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.train import augment as jaug
from chessvision_tpu_torch.ops.warp import warp_perspective
from chessvision_tpu_torch.train import augment as aug


def _smooth(shape, seed=0) -> np.ndarray:
    """Blurred noise in [0, 1] over the two axes after the first."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    for _ in range(3):
        x = (x + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 3
        x = (x + np.roll(x, 1, 2) + np.roll(x, -1, 2)) / 3
    return x.astype(np.float32)


def _masks(b=4, size=64) -> np.ndarray:
    m = np.zeros((b, size, size), np.float32)
    m[:, size // 6 : 5 * size // 6, size // 5 : 4 * size // 5] = 1.0
    return m


def test_segmentation_augment_contracts() -> None:
    imgs = torch.from_numpy(np.random.default_rng(0).random((4, 64, 64, 3)).astype(np.float32))
    ai, am = aug.augment_segmentation_batch(0, imgs, torch.from_numpy(_masks()))
    assert ai.shape == imgs.shape and am.shape == (4, 64, 64)
    assert float(ai.min()) >= 0.0 and float(ai.max()) <= 1.0
    assert float(((am > 0.1) & (am < 0.9)).float().mean()) < 0.05  # masks stay near-binary


def test_segmentation_augment_deterministic() -> None:
    imgs = torch.from_numpy(np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32))
    msks = torch.zeros((2, 64, 64))
    a1, _ = aug.augment_segmentation_batch(7, imgs, msks)
    a2, _ = aug.augment_segmentation_batch(7, imgs, msks)
    torch.testing.assert_close(a1, a2, atol=0, rtol=0)
    a3, _ = aug.augment_segmentation_batch(8, imgs, msks)
    assert not torch.equal(a1, a3)
    assert aug.fold_in(7, 1) != aug.fold_in(7, 2) and aug.fold_in(7, 1) == aug.fold_in(7, 1)


def test_classification_augment_contracts() -> None:
    sq = torch.from_numpy(np.random.default_rng(2).random((8, 64, 64, 1)).astype(np.float32))
    aq = aug.augment_classification_batch(0, sq)
    assert aq.shape == sq.shape and float(aq.min()) >= 0.0 and float(aq.max()) <= 1.0
    assert abs(float(aq.mean()) - float(sq.mean())) < 0.15


def test_identity_matrices_are_noops() -> None:
    imgs = torch.from_numpy(np.random.default_rng(0).random((3, 64, 64)).astype(np.float32))
    out = aug._warp_nhwc(imgs, aug._rotation_matrices(torch.zeros(3), 64, 64))
    torch.testing.assert_close(out, imgs, atol=0, rtol=0)
    out = aug._warp_nhwc(imgs, aug._affine_matrices(torch.zeros(3), torch.zeros(3), torch.ones(3), 64, 64))
    torch.testing.assert_close(out, imgs, atol=0, rtol=0)


def test_rotation_moves_content() -> None:
    img = torch.zeros((1, 64, 64))
    img[0, 10:20, 40:50] = 1.0
    out = aug._warp_nhwc(img, aug._rotation_matrices(torch.tensor([45.0]), 64, 64))
    assert float(out.sum()) > 50 and float(out[0, 10:20, 40:50].abs().sum()) < float(out.sum()) * 0.5


def test_twopass_matches_bilinear_at_moderate_rotation() -> None:
    img = torch.from_numpy(_smooth((1, 64, 64))[0])
    for ang in [-45.0, -30.0, 0.0, 30.0, 45.0]:
        m = aug._rotation_matrices(torch.tensor([ang]), 64, 64)[0]
        a = warp_perspective(img, m, (64, 64), method="twopass")
        b = warp_perspective(img, m, (64, 64), method="bilinear")
        assert float((a - b).abs()[8:-8, 8:-8].mean()) < 0.02, ang


def test_matrices_and_warp_match_jax() -> None:
    rng = np.random.default_rng(4)
    angles = rng.uniform(-15, 15, 6).astype(np.float32)
    tx, ty = (rng.uniform(-6, 6, 6).astype(np.float32) for _ in range(2))
    scale = rng.uniform(0.95, 1.05, 6).astype(np.float32)
    for got, want in (
        (aug._rotation_matrices(torch.from_numpy(angles), 64, 48), jaug._rotation_matrices(jnp.asarray(angles), 64, 48)),
        (aug._affine_matrices(*map(torch.from_numpy, (tx, ty, scale)), 64, 48),
         jaug._affine_matrices(*map(jnp.asarray, (tx, ty, scale)), 64, 48)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ms = np.asarray(jnp.einsum("bij,bjk->bik", jaug._rotation_matrices(jnp.asarray(angles), 48, 48),
                               jaug._affine_matrices(*map(jnp.asarray, (tx, ty, scale)), 48, 48)))
    for imgs in (_smooth((6, 48, 48)), np.moveaxis(_smooth((6 * 3, 48, 48)).reshape(6, 3, 48, 48), 1, -1).copy()):
        got = aug._warp_nhwc(torch.from_numpy(imgs), torch.from_numpy(ms)).numpy()
        want = np.asarray(jaug._warp_nhwc(jnp.asarray(imgs), jnp.asarray(ms)))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_photometric_helpers_match_jax_at_given_draws() -> None:
    key = jax.random.PRNGKey(3)
    img = _smooth((6, 32, 32 * 3)).reshape(6, 32, 32, 3)
    apply = np.array([True, False, True, True, False, True])
    # the draws the JAX helpers make from ``key``
    kb, kc, ks, kh = jax.random.split(key, 4)
    draws = [np.asarray(jax.random.uniform(k, (6,), minval=lo, maxval=hi))
             for k, lo, hi in ((kb, 0.9, 1.1), (kc, 0.9, 1.1), (ks, 0.9, 1.1), (kh, -0.1, 0.1))]
    want = np.asarray(jaug._color_jitter_batch(key, jnp.asarray(img), jnp.asarray(apply)))
    got = aug._color_jitter(torch.from_numpy(img), torch.from_numpy(apply), *map(torch.from_numpy, draws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    sigma = np.asarray(jax.random.uniform(key, (6,), minval=0.1, maxval=2.0))
    want = np.asarray(jaug._gaussian_blur3_batch(key, jnp.asarray(img), jnp.asarray(apply)))
    got = aug._gaussian_blur3(torch.from_numpy(img), torch.from_numpy(apply), torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    kp, ks2, kd = jax.random.split(key, 3)
    sel = np.asarray(jax.random.uniform(kp, (6,)) < 0.3)
    strength = np.asarray(jax.random.uniform(ks2, (6,), minval=0.25, maxval=0.65))
    direction = np.asarray(jax.random.randint(kd, (6,), 0, 4))
    want = np.asarray(jaug._illum_gradient_batch(key, jnp.asarray(img)))
    got = aug._illum_gradient(torch.from_numpy(img), torch.from_numpy(sel), torch.from_numpy(strength),
                              torch.from_numpy(direction))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_segmentation_angles_are_integers(monkeypatch) -> None:
    seen = []
    orig = aug._rotation_matrices
    monkeypatch.setattr(aug, "_rotation_matrices", lambda a, h, w: seen.append(a.clone()) or orig(a, h, w))
    aug.augment_segmentation_batch(5, torch.rand(16, 32, 32, 3), torch.zeros(16, 32, 32))
    (angles,) = seen
    assert torch.equal(angles, torch.round(angles)) and float(angles.min()) >= -15 and float(angles.max()) < 15
    assert bool((angles == 0).any()) and bool((angles != 0).any())  # some samples not rotated


def test_classification_cutout_erases_and_preserves_shape() -> None:
    grad = torch.linspace(0, 1, 64)[None, None, :, None].expand(16, 64, 64, 1).contiguous()
    with_cut = aug.augment_classification_batch(0, grad, photometric=False, cutout=True)
    without = aug.augment_classification_batch(0, grad, photometric=False, cutout=False)
    assert with_cut.shape == grad.shape
    changed = (with_cut - without).abs().amax(dim=(1, 2, 3)) > 1e-6
    assert bool(changed.any()) and not bool(changed.all())


def test_illum_gradient_contracts_and_leaves_other_draws_unchanged() -> None:
    imgs = torch.from_numpy(_smooth((8, 32, 32 * 3)).reshape(8, 32, 32, 3))
    msk = torch.from_numpy(_masks(8, 32))
    a_img, a_msk = aug.augment_segmentation_batch(5, imgs, msk)
    c_img, c_msk = aug.augment_segmentation_batch(5, imgs, msk, illum_gradient=True)
    torch.testing.assert_close(a_msk, c_msk, atol=0, rtol=0)  # masks never touched
    changed = (a_img - c_img).abs().amax(dim=(1, 2, 3)) > 0
    # samples the gradient skipped are bit-identical: every other draw held
    assert bool(changed.any()) and not bool(changed.all())
    ramp = aug._illum_gradient(imgs, torch.ones(8, dtype=torch.bool), torch.full((8,), 0.5), torch.arange(8) % 4)
    assert float((ramp - imgs).max()) <= 1e-6 and float(ramp.min()) >= 0.0


@pytest.mark.parametrize("flag", ["dim", "fade", "cutout"])
def test_classifier_flags_leave_other_draws_unchanged(flag) -> None:
    crops = torch.from_numpy(_smooth((16, 64, 64))[..., None])
    base = aug.augment_classification_batch(9, crops, photometric=False)
    on = aug.augment_classification_batch(9, crops, photometric=False, **{flag: True})
    assert on.shape == crops.shape and float(on.min()) >= 0.0 and float(on.max()) <= 1.0
    # an unselected crop comes out unchanged (fade computes L − 1·(L − x),
    # equal to x up to rounding)
    changed = (on - base).abs().amax(dim=(1, 2, 3)) > 1e-6
    assert bool(changed.any()) and not bool(changed.all())
    if flag == "dim":  # multiplicative only
        assert float((on - base).max()) <= 1e-6
    if flag == "fade":  # a faded crop's interior contrast shrinks
        mid = (slice(None), slice(16, 48), slice(16, 48))
        assert bool((on[mid][changed].std(dim=(1, 2, 3)) < base[mid][changed].std(dim=(1, 2, 3))).all())
