"""The port's CUDA kernels on the card against their plain versions.

Every test here needs an NVIDIA GPU and nvcc and skips without them; this
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chessvision_tpu_torch.ops import hat_resample

pytestmark = pytest.mark.cuda


def _need_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (a CUDA kernel has no CPU mode)")


def _case(name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The three cases of tests/test_pallas_kernels.py, on the card."""
    rng = np.random.default_rng({"in_range": 0, "borders": 1, "upscale": 2}[name])
    src = rng.random((32, 512)).astype(np.float32)
    if name == "in_range":
        pos = np.stack([np.linspace(10, 10 + 511 * 0.9, 512) + i for i in range(32)])
    elif name == "borders":
        pos = np.stack([np.linspace(-3, 514, 512) + 0.3 * i for i in range(32)])
    else:
        pos = np.stack([200 + np.linspace(0, 100, 512)] * 32)
    return torch.from_numpy(src).cuda(), torch.from_numpy(pos.astype(np.float32)).cuda()


@pytest.mark.parametrize("case", ["in_range", "borders", "upscale"])
def test_hat_resample_kernel_matches_plain(case) -> None:
    _need_card()
    src, pos = _case(case)
    before = hat_resample.launches
    got = hat_resample.hat_resample(src, pos)
    torch.cuda.synchronize()
    assert hat_resample.launches == before + 1
    # the same weights, products and one rounded sum: bit-exact
    torch.testing.assert_close(got, hat_resample.hat_resample_plain(src, pos), atol=0, rtol=0)


def test_hat_resample_kernel_reads_transposed_rows() -> None:
    """Pass 2 hands the kernel a transposed (non-contiguous) view."""
    _need_card()
    src = torch.rand((2, 512, 576), device="cuda").transpose(1, 2)  # (2, 576, 512)
    pos = torch.rand((2, 576, 576), device="cuda") * 520 - 4
    got = hat_resample.hat_resample(src, pos)
    torch.testing.assert_close(got, hat_resample.hat_resample_plain(src, pos), atol=0, rtol=0)


def test_hat_resample_kernel_rejects_other_dtypes() -> None:
    _need_card()
    with pytest.raises(TypeError):
        hat_resample.hat_resample(torch.zeros(4, 8, device="cuda", dtype=torch.float16),
                                  torch.zeros(4, 8, device="cuda"))
