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

from chessvision_tpu_torch.ops import hat_resample, warp

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
    before = torch.cuda.memory_allocated()
    got = hat_resample.hat_resample(src, pos)
    # read in place: the call holds its output and no copy of the source
    assert torch.cuda.memory_allocated() - before <= got.numel() * 4 + 4096
    torch.testing.assert_close(got, hat_resample.hat_resample_plain(src, pos), atol=0, rtol=0)


def test_hat_resample_kernel_rejects_other_dtypes() -> None:
    _need_card()
    with pytest.raises(TypeError):
        hat_resample.hat_resample(torch.zeros(4, 8, device="cuda", dtype=torch.float16),
                                  torch.zeros(4, 8, device="cuda"))


# -- the two-pass warp entry: positions computed in the kernels ---------------------


def _minv_from_quads(quads: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """Inverse homographies (B, 3, 3) on the card taking each (4, 2) quad
    onto the whole (out_w, out_h) canvas."""
    dest = torch.tensor([[0, 0], [out_w, 0], [out_w, out_h], [0, out_h]], dtype=torch.float32)
    q = torch.from_numpy(np.asarray(quads, np.float32))
    ms = warp.get_perspective_transform(q, dest.expand(len(q), 4, 2))
    return warp.invert_homography(ms).contiguous().cuda()


def _rotated(deg: float, side: float, cx: float, cy: float) -> np.ndarray:
    a = np.deg2rad(deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * side / 2 @ rot.T + [cx, cy]


def _warp_case(name: str) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """(imgs, minv, out_h, out_w) on the card, B=2, made from a seed."""
    rng = np.random.default_rng(sorted(_WARP_CASES).index(name))
    h, w, out_h, out_w = _WARP_CASES[name]
    imgs = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.float32)).cuda()
    frame = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    if name == "random_quads":
        quads = frame * 0.6 + [0.2 * w, 0.2 * h] + rng.uniform(-0.08, 0.08, (2, 4, 2)) * [w, h]
    elif name == "rotated":
        quads = np.stack([_rotated(30, 0.55 * w, w / 2, h / 2), _rotated(-30, 0.6 * w, 0.45 * w, 0.55 * h)])
    elif name == "out_of_frame":
        quads = np.stack([_rotated(8, 0.8 * w, 0.8 * w, 0.75 * h), _rotated(-12, 0.9 * w, 0.1 * w, 0.2 * h)])
    elif name == "identity":  # the quad the engine gives a board it did not find
        quads = np.stack([np.array([[0, 0], [512, 0], [512, 512], [0, 512]], np.float64)] * 2)
    elif name == "guarded_denominators":
        # e − y·h = 0 on source row 256, and g·u + h·v + i = 0 on output row 0
        m = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 3.0], [0.0, 1.0 / 256.0, 0.0]])
        return imgs, torch.stack([m, m * 0.5]).cuda(), out_h, out_w
    elif name == "wide_rows":  # pass 1 stages more than the default 48 KB of shared memory
        quads = np.array([[[100, 2], [1900, 1], [1950, 14], [50, 13]], [[0, 0], [2048, 0], [2048, 16], [0, 16]]], np.float64)
    else:  # the widths off the 16-byte paths
        quads = np.stack([_rotated(10, 0.7 * w, w / 2, h / 2), _rotated(-20, 0.6 * w, w / 2, h / 2)])
    return imgs, _minv_from_quads(quads, out_h, out_w), out_h, out_w


_WARP_CASES = {  # name: (h, w, out_h, out_w)
    "random_quads": (512, 512, 576, 576),
    "rotated": (512, 512, 576, 576),
    "out_of_frame": (512, 512, 576, 576),
    "identity": (512, 512, 512, 512),
    "guarded_denominators": (512, 512, 576, 576),
    "odd_out_width": (64, 64, 50, 61),
    "odd_src_width": (50, 67, 45, 64),
    "odd_both": (33, 30, 41, 70),
    "wide_rows": (16, 2048, 24, 40),
}


@pytest.mark.parametrize("case", sorted(_WARP_CASES))
def test_warp_twopass_kernel_matches_plain(case) -> None:
    _need_card()
    imgs, minv, out_h, out_w = _warp_case(case)
    before = hat_resample.launches
    got = hat_resample.warp_twopass(imgs, minv, out_h, out_w)
    torch.cuda.synchronize()
    assert hat_resample.launches == before + 2  # one launch a pass
    assert got.shape == (2, out_h, out_w) and got.is_contiguous()
    want = hat_resample.warp_twopass_plain(imgs, minv, out_h, out_w)
    assert bool(torch.isfinite(want).all())
    # the kernels round every operation of the position math as the plain
    # version's eager ops do, and share its two-tap arithmetic: bit-exact
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert float(want.abs().max()) > 0


def test_warp_twopass_kernel_rejects_noncontiguous_images() -> None:
    _need_card()
    imgs = torch.rand((2, 64, 128), device="cuda")[:, :, ::2]
    minv = torch.eye(3, device="cuda").expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError):
        hat_resample.warp_twopass(imgs, minv, 64, 64)
    with pytest.raises(TypeError):
        hat_resample.warp_twopass(imgs.contiguous().half(), minv, 64, 64)


def test_unkept_variants_equal_kept_kernels(capsys) -> None:
    """The staged pass 2 and the fused warp (``csrc/variants``) build and
    give the kept kernels' floats; the script exits non-zero otherwise."""
    _need_card()
    from chessvision_tpu_torch import k1_variants

    assert k1_variants.main(["--batch", "4"]) == 0
    assert "warp_fused_ms" in capsys.readouterr().out
