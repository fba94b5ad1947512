"""The quadrangle's decimation (``ops/quad.py``) on the CPU.

- ``decimate_to_quad`` on CPU tensors takes the plain version: no kernel is
  built or launched (``quad.launches`` stays 0), and ``find_quadrangle_batch``
  goes the same way;
- the wrapper refuses what the kernel does not take, on any device;
- ``decimate_to_quad_plain`` equals the JAX package's ``decimate_to_quad``
  (one polygon a call, under ``jax.vmap``) bit for bit on the tie-heavy
  polygons of ``tests/_quad_cases.py`` and on the masks' support points:
  the inputs that the card tests hold the kernel to the plain version on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.ops import quad as jquad
from chessvision_tpu_torch import cuda_build
from chessvision_tpu_torch.ops import quad
from tests._quad_cases import POLYGON_KINDS, mask_support_points, masks, polygons

KS = (4, 5, 64, 256)
BATCH = 128  # the first 128 of the card test's polygons


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse(name: str):
        raise AssertionError(f"the CPU path asked for the kernel {name!r}")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(quad, "launches", 0)


def test_cpu_tensors_take_the_plain_path_without_a_kernel(no_kernel) -> None:
    pts = torch.from_numpy(polygons("star", 64, 8))
    got = quad.decimate_to_quad(pts)
    torch.testing.assert_close(got, quad.decimate_to_quad_plain(pts), atol=0, rtol=0)
    quad.find_quadrangle_batch(torch.from_numpy(np.stack(list(masks().values()))), 0.5)
    assert quad.launches == 0


def test_an_empty_cpu_batch_gives_no_corners(no_kernel) -> None:
    got = quad.decimate_to_quad(torch.zeros((0, 64, 2)))
    assert got.shape == (0, 4, 2) and got.dtype == torch.float32 and quad.launches == 0


@pytest.mark.parametrize(
    "points",
    [torch.zeros((2, 64, 2), dtype=torch.float64), torch.zeros((2, 3, 2)), torch.zeros((2, 257, 2)),
     torch.zeros((64, 2)), torch.zeros((2, 64, 3))],
    ids=["float64", "k3", "k257", "unbatched", "three_coords"],
)
def test_the_wrapper_refuses_what_the_kernel_does_not_take(points, no_kernel) -> None:
    with pytest.raises((TypeError, ValueError)):
        quad.decimate_to_quad(points)


def _inputs(kind: str, k: int) -> np.ndarray:
    return mask_support_points() if kind == "masks" else polygons(kind, k, BATCH)


@pytest.mark.parametrize(("kind", "k"), [(kind, k) for kind in POLYGON_KINDS for k in KS] + [("masks", 64)])
def test_plain_decimation_equals_jax_bit_for_bit(kind, k) -> None:
    pts = _inputs(kind, k)
    want = np.asarray(jax.vmap(jquad.decimate_to_quad)(jnp.asarray(pts)))
    got = quad.decimate_to_quad_plain(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
