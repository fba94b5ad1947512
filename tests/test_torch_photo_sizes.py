"""The port on frames that are not square, against the JAX package, on the CPU.

Camera photos are not square, and both packages warp the board from the
full-resolution gray frame: only the segmenter sees the 256² resize.  So
the warp's source rows are as wide as the photo, the area resize takes
its matmul path (fractional boxes), and ``scale_quadrangle`` scales x by
the height (a reference quirk both packages keep: on a portrait frame the
quad passes the right edge and the warp reads K1's zero border).

- ``Engine.process_batch`` with the stub models of tests/test_torch_engine.py
  on (600, 800) and (803, 601) frames of ``synthetic.photo_frames``:
  ``found``, FENs, original FENs and fixes equal; quads within 1e-3 px;
  ``comp`` and ``gray`` bit-identical; boards within 1 gray level on
  ≥ 99.9% of pixels (XLA's jitted float32 homography algebra and
  PyTorch's round differently in the last bits, as in
  ``test_refine_modes_match_jax``);
- ``ChessVision.process_image`` on one non-square frame in both facades;
- pass 1's launch plan (``hat_resample.pass1_plan``), the pure function
  that picks the rows a block stages, within a block's shared memory for
  every width the JAX warp takes.

The camera sizes themselves (12–48 MP) run on the card only: the JAX
package's dense warp would weigh 3 024 × 4 032 × 576 floats a pass at
12 MP (``chip_smoke.py`` phase 17, ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.core import ChessVision as JaxChessVision
from chessvision_tpu.engine import preprocess_images as jax_preprocess
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.engine import preprocess_images
from chessvision_tpu_torch.ops import hat_resample
from chessvision_tpu_torch.synthetic import photo_frames
from tests.test_torch_engine import STUB_QUAD, _assert_same, _engines, _quad_logits, _start_position_logits

SIZES = [(600, 800), (803, 601)]


@pytest.fixture(scope="module")
def stub_pair():
    return _engines(_quad_logits(STUB_QUAD), _start_position_logits())


def _boards_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, (diff.max(), np.mean(diff == 0))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_engine_matches_jax_on_non_square_frames(stub_pair, hw) -> None:
    port, ref = stub_pair
    images, _ = photo_frames(sum(hw), 2, *hw)
    comp, gray = preprocess_images(torch.from_numpy(images))
    want_comp, want_gray = jax_preprocess(jnp.asarray(images))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(want_comp))
    np.testing.assert_array_equal(gray.numpy(), np.asarray(want_gray))

    got, want = port.process_batch(images), ref.process_batch(images)
    assert list(got.board_found) == [True, True]
    assert got.board_image.shape == (2, 512, 512)
    # the quad is scaled by h / 256 on both axes (the quirk): on the
    # portrait frame its right edge lies past the frame's, not on the other
    assert (got.quadrangle[..., 0].max() > hw[1]) == (hw[0] > hw[1])
    _assert_same(got, want, quad_atol=1e-3)
    _boards_close(got.board_image, want.board_image)


def test_process_image_matches_jax_on_a_non_square_frame(stub_pair) -> None:
    """Both facades with the stub engines, on one portrait frame."""
    port_engine, ref_engine = stub_pair
    port, ref = ChessVision(device="cpu"), JaxChessVision(dtype=jnp.float32)
    port._engine, ref._engine = port_engine, ref_engine
    frame = photo_frames(7, 1, 803, 601)[0][0]
    got, want = port.process_image(frame), ref.process_image(frame)
    assert got.position is not None and want.position is not None
    assert (got.position.fen, got.position.original_fen) == (want.position.fen, want.position.original_fen)
    np.testing.assert_allclose(got.board_extraction.quadrangle, want.board_extraction.quadrangle, atol=1e-3)
    np.testing.assert_array_equal(got.board_extraction.binary_mask, want.board_extraction.binary_mask)
    _boards_close(got.board_extraction.board_image, want.board_extraction.board_image)
    np.testing.assert_allclose(got.position.model_probabilities, want.position.model_probabilities, atol=1e-5)


# widths of 512² frames, a 12 MP photo's odd and even widths, the last
# width whose 8 rows fit, the first that does not, 48, 200 and 58 112+ MP rows
PLAN_WIDTHS = [512, 4031, 4032, 7264, 7265, 8064, 16320, 58112, 58113, 60000]


@pytest.mark.parametrize("w", PLAN_WIDTHS)
def test_pass1_plan_fits_shared_memory_at_every_width(w) -> None:
    rows, smem = hat_resample.pass1_plan(w)
    assert rows in (8, 4, 2, 1)
    assert 0 <= smem <= hat_resample._SHARED_BYTES
    if smem:  # staged: the block's rows, exactly, and the most rows that fit
        assert smem == rows * w * 4
        assert rows == 8 or 2 * rows * w * 4 > hat_resample._SHARED_BYTES
    else:  # a row wider than a block's shared memory reads device memory
        assert w * 4 > hat_resample._SHARED_BYTES


def test_pass1_plan_by_width() -> None:
    plan = hat_resample.pass1_plan
    assert plan(512) == (8, 16384)
    assert plan(4032) == (8, 129024)
    assert plan(7264) == (8, 232448)
    assert plan(7265) == (4, 116240)
    assert plan(8064) == (4, 129024)
    assert plan(16320) == (2, 130560)
    assert plan(58112) == (1, 232448)
    assert plan(60000) == (8, 0)


def test_warp_twopass_wide_rows_on_the_cpu_match_jax() -> None:
    """K1's entry on the CPU (its plain version) at a source width past
    the old shared-memory limit, against the JAX warp's XLA form: three
    rows of 8 064 floats through an affine map whose inverse and positions
    are exact in float32 in both packages (x = 1024 u − 2047.625, y = v),
    so the results must be equal: zero where u lands outside the row."""
    from chessvision_tpu.ops.warp import _warp_batched_twopass as jax_twopass
    from chessvision_tpu_torch.ops.warp import _warp_batched_twopass

    imgs = np.random.default_rng(3).integers(0, 256, (1, 3, 8064)).astype(np.float32)
    ms = np.array([[[2.0**-10, 0.0, 2.0 - 0.375 / 1024], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    got = _warp_batched_twopass(torch.from_numpy(imgs), torch.from_numpy(ms), 3, 11).numpy()
    want = np.asarray(jax_twopass(jnp.asarray(imgs), jnp.asarray(ms), 3, 11))
    np.testing.assert_array_equal(got, want)
    assert (got[..., :2] == 0).all() and (got[..., 10] == 0).all() and (got[..., 2:10] != 0).any()
