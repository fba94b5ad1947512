"""The engine's threshold mask, split by the logit and settled in the band,
against the host formula it replaces, bit for bit, on the CPU.

The formula is the JAX package's (``chessvision_tpu/engine.py``,
``Engine.process_batch``), written out here as it stands there:
``1 / (1 + exp(-x, float32)) > t``.  The split is ``ops/mask.py``'s plain
version (the CPU's path; on the card the kernel of ``csrc/mask.cu``, held
to the plain version in ``tests/test_torch_cuda.py``) and the host's own
split (a mesh that spans processes), each settled by
``engine._binary_mask``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.ops import mask as mask_ops
# by its own name (pytest puts tests/ on the path), as the card's tests import it
from _mask_cases import (PLANTED_IN_BAND, THRESHOLDS, FlatClassifier, PlantedExtractor, edge_logits, listed,
                         old_formula)

@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_band_edges_are_float32_around_the_logit_of_the_threshold(threshold) -> None:
    lo, hi = mask_ops.band(threshold)
    c = np.log(threshold / (1 - threshold))
    assert float(np.float32(lo)) == lo and float(np.float32(hi)) == hi
    # s'(x) = s (1 - s): a relative width 2 REL about t is 2 REL / (1 - t) in x
    assert lo < c < hi and hi - lo < 3 * mask_ops.REL / (1 - threshold)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_plain_split_settled_equals_the_old_formula(threshold) -> None:
    logits = edge_logits(threshold)
    want = old_formula(logits, threshold)
    dev = engine_mod._device_mask(torch.from_numpy(logits), threshold)
    mask, band = dev["binary_mask"].numpy(), dev["band"].numpy()
    lo, hi = mask_ops.band(threshold)
    inside = (logits > np.float32(lo)) & (logits <= np.float32(hi))
    # outside the band the split alone is the formula; the band is what the host settles
    assert np.array_equal(mask[~inside], want[~inside])
    # at t = 0.5, 0.7 and 0.99 more than the list holds: the host then scans for them
    assert 0 < band[0] == inside.sum()
    assert listed(dev["band"]) == np.flatnonzero(inside)[: mask_ops.BAND_LIST].tolist()
    before = engine_mod.mask_band_pixels
    got = engine_mod._binary_mask(logits, threshold, mask, band)
    assert engine_mod.mask_band_pixels - before == inside.sum()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_host_split_equals_the_old_formula(threshold) -> None:
    """A mesh that spans processes gets its logits on the host: there the
    host splits them itself."""
    logits = edge_logits(threshold)
    got = engine_mod._binary_mask(logits, threshold)
    assert got.dtype == np.uint8 and np.array_equal(got, old_formula(logits, threshold))


def test_planted_band_pixel_is_settled_and_counted() -> None:
    rng = np.random.default_rng(3)
    logits = np.where(rng.random((2, 256, 256)) < 0.5, 8.0, -8.0).astype(np.float32)
    lo, hi = mask_ops.band(0.5)
    planted = np.float32(np.nextafter(np.float32(0.0), np.float32(1.0)))  # the least positive float32
    logits[1, 17, 42] = planted
    assert lo < planted <= hi and old_formula(planted[None], 0.5)[0] == 0  # 1/(1+exp(-tiny)) rounds to 0.5
    dev = engine_mod._device_mask(torch.from_numpy(logits), 0.5)
    assert int(dev["band"][0]) == 1 and listed(dev["band"]) == [65536 + 17 * 256 + 42]
    before = engine_mod.mask_band_pixels
    got = engine_mod._binary_mask(logits, 0.5, dev["binary_mask"].numpy(), dev["band"].numpy())
    assert engine_mod.mask_band_pixels == before + 1
    assert np.array_equal(got, old_formula(logits, 0.5))


def test_device_mask_with_no_band_pixel_is_returned_as_it_came() -> None:
    logits = np.where(np.random.default_rng(4).random((2, 256, 256)) < 0.3, 5.0, -5.0).astype(np.float32)
    dev = engine_mod._device_mask(torch.from_numpy(logits), 0.5)
    mask = dev["binary_mask"].numpy()
    before = engine_mod.mask_band_pixels
    got = engine_mod._binary_mask(logits, 0.5, mask, dev["band"].numpy())
    assert got is mask and engine_mod.mask_band_pixels == before
    assert np.array_equal(got, old_formula(logits, 0.5))


@pytest.mark.parametrize("threshold", [0.0, 1.0, -0.25, 1.5, float("nan"), 2.0 ** -101, 1 - 2.0 ** -18])
def test_threshold_outside_the_split_takes_the_host_formula(threshold) -> None:
    logits = edge_logits(0.5)[:1]
    assert mask_ops.band(threshold) is None
    assert engine_mod._device_mask(torch.from_numpy(logits), threshold) == {}
    before = engine_mod.mask_band_pixels
    got = engine_mod._binary_mask(logits, threshold)
    assert engine_mod.mask_band_pixels == before + logits.size
    assert np.array_equal(got, old_formula(logits, threshold))


def test_plain_version_of_no_boards() -> None:
    mask, band = mask_ops.binary_mask(torch.zeros((0, 256, 256)), *mask_ops.band(0.5))
    assert mask.shape == (0, 256, 256) and mask.dtype == torch.uint8
    assert band.shape == (1 + mask_ops.BAND_LIST,) and band.dtype == torch.int32 and int(band[0]) == 0


def test_band_beyond_the_list_is_found_by_scanning() -> None:
    """More band pixels than the list holds: the host scans the logits for
    them, and the mask is still the formula's."""
    logits = np.where(np.random.default_rng(6).random((2, 256, 256)) < 0.5, 3.0, -3.0).astype(np.float32)
    logits[0, :40] = 0.0  # 10 240 band pixels
    dev = engine_mod._device_mask(torch.from_numpy(logits), 0.5)
    assert int(dev["band"][0]) == 40 * 256 > mask_ops.BAND_LIST
    before = engine_mod.mask_band_pixels
    got = engine_mod._binary_mask(logits, 0.5, dev["binary_mask"].numpy(), dev["band"].numpy())
    assert engine_mod.mask_band_pixels == before + 40 * 256
    assert np.array_equal(got, old_formula(logits, 0.5))


def test_binary_mask_refuses_what_it_does_not_take() -> None:
    with pytest.raises(TypeError):
        mask_ops.binary_mask(torch.zeros((2, 8, 8), dtype=torch.float64), -1.0, 1.0)


# -- through Engine.process_batch -------------------------------------------------------------


def test_process_batch_mask_equals_the_old_formula_with_band_pixels(monkeypatch) -> None:
    engine = Engine(PlantedExtractor(), FlatClassifier(), refine_grid="off", device="cpu")
    calls = []
    binary_mask = engine_mod._binary_mask
    monkeypatch.setattr(engine_mod, "_binary_mask", lambda *a, **k: calls.append(1) or binary_mask(*a, **k))
    frames = np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3), np.uint8)
    before, launches = engine_mod.mask_band_pixels, mask_ops.launches
    res = engine.process_batch(frames, threshold=0.5)
    assert len(calls) == 1 and mask_ops.launches == launches  # the CPU launches no kernel
    assert engine_mod.mask_band_pixels - before == PLANTED_IN_BAND
    assert res.binary_mask.dtype == np.uint8 and res.binary_mask.shape == (2, 256, 256)
    assert np.array_equal(res.binary_mask, old_formula(res.logits, 0.5))
    # lite copies back no logits and makes no mask
    lite = engine.process_batch(frames, threshold=0.5, lite=True)
    assert len(calls) == 1 and lite.binary_mask.shape == (2, 0, 0)


def _device_outputs(logits: np.ndarray) -> dict[str, np.ndarray]:
    """What an engine's ``run_device`` hands ``process_batch``, around the
    given logits: no board found, so only the mask depends on them."""
    b = len(logits)
    return {"logits": logits, "found": np.zeros(b, bool), "quadrangle": np.zeros((b, 4, 2), np.float32),
            "probabilities": np.full((b, 64, 13), 1 / 13, np.float32), "board_image": np.zeros((b, 512, 512), np.uint8)}


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_process_batch_mask_equals_the_jax_engines(threshold, monkeypatch) -> None:
    """Both engines' ``process_batch`` on the same device outputs, the
    band-covering logits among them: the port's mask (split, then settled)
    is the JAX package's host mask, computed by that package's own line,
    and so is the formula the other tests hold the port to."""
    from chessvision_tpu.engine import Engine as JaxEngine

    logits = edge_logits(threshold)
    frames = np.zeros((len(logits), 256, 256, 3), np.uint8)
    ref = JaxEngine(None, {}, None, {})
    monkeypatch.setattr(ref, "run_device", lambda images, thr: _device_outputs(logits))
    want = ref.process_batch(frames, threshold=threshold).binary_mask
    port = Engine(PlantedExtractor(), FlatClassifier(), refine_grid="off", device="cpu")
    monkeypatch.setattr(port, "run_device", lambda images, thr: {
        k: torch.from_numpy(v) for k, v in _device_outputs(logits).items()})
    got = port.process_batch(frames, threshold=threshold).binary_mask
    assert want.dtype == got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(want, old_formula(logits, threshold))


def test_microbench_mask_runs_only_on_the_card() -> None:
    from chessvision_tpu_torch.tools import microbench

    with pytest.raises(ValueError, match="only on the card"):
        microbench.main(["--which", "mask", "--device", "cpu"])
