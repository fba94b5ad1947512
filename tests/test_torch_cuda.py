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


def _k1_calls(fn) -> list[tuple]:
    """The arguments of every warp_twopass call ``fn`` makes."""
    calls = []
    orig = hat_resample.warp_twopass

    def recording(*args):
        calls.append(args)
        return orig(*args)

    hat_resample.warp_twopass = recording
    try:
        fn()
    finally:
        hat_resample.warp_twopass = orig
    return calls


@pytest.mark.parametrize("kind", ["segmentation", "classifier"])
def test_k1_at_the_augmentation_shapes_matches_plain(kind) -> None:
    """The trainers' augmentations hand K1 256² planes (B=32: 96 image and
    32 mask planes) and 64² squares (B=256); bit-exact as on the main path."""
    _need_card()
    from chessvision_tpu_torch.train import augment

    g = torch.Generator(device="cpu").manual_seed(0)
    if kind == "segmentation":
        imgs = torch.rand((32, 256, 256, 3), generator=g).cuda()
        masks = (torch.rand((32, 256, 256), generator=g) > 0.5).float().cuda()
        calls = _k1_calls(lambda: augment.augment_segmentation_batch(1, imgs, masks, illum_gradient=True))
        assert [c[0].shape for c in calls] == [(96, 256, 256), (32, 256, 256)]
    else:
        imgs = torch.rand((256, 64, 64, 1), generator=g).cuda()
        calls = _k1_calls(lambda: augment.augment_classification_batch(1, imgs, cutout=True, dim=True, fade=True))
        assert [c[0].shape for c in calls] == [(256, 64, 64)]
    for args in calls:
        got = hat_resample.warp_twopass(*args)
        torch.testing.assert_close(got, hat_resample.warp_twopass_plain(*args), atol=0, rtol=0)


@pytest.mark.parametrize("kind", ["unet", "resnet18"])
def test_one_bf16_train_step_on_the_card(kind) -> None:
    """One bfloat16 train step per model family on the card: finite loss,
    float32 master weights that moved, BatchNorm statistics updated."""
    _need_card()
    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.train import steps

    torch.manual_seed(0)
    if kind == "unet":
        model = models.UNet(base=8)
        tx = steps.Chain([steps.ClipByGlobalNorm(1.0), steps.AddDecayedWeights(1e-8),
                          steps.inject_hyperparams(steps.rmsprop, learning_rate=1e-3, momentum=0.999, eps=1e-8)])
        step = steps.make_seg_train_step()
        x = torch.rand((4, 64, 64, 3), device="cuda")
        y = (torch.rand((4, 64, 64), device="cuda") > 0.5).float()
    else:
        model = models.resnet18(width=16)
        tx = steps.adam(1e-3)
        step = steps.make_cls_train_step()
        x = torch.rand((32, 64, 64, 1), device="cuda")
        y = torch.arange(32, device="cuda") % 13
    model = set_compute_dtype(model, torch.bfloat16, master_weights=True).cuda()
    state = steps.TrainState.create(model, tx)
    before = [p.detach().clone() for p in state.params]
    stats = [b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")]
    metrics = step(state, x, y)
    assert torch.isfinite(metrics["loss"]).item()
    assert all(p.dtype == torch.float32 for p in state.params)
    assert any(not torch.equal(a, p.detach()) for a, p in zip(before, state.params))
    after = [b for n, b in model.named_buffers() if n.endswith("running_mean")]
    assert any(not torch.equal(a, b) for a, b in zip(stats, after))


@pytest.mark.parametrize("kind", ["unet", "resnet18"])
def test_world_size_one_nccl_mesh_step_equals_plain_step(kind, tmp_path) -> None:
    """A mesh of one process over NCCL on the card: the step with its
    collectives (BatchNorm sums, the gradient all-reduce, the metric
    means) equals the step without a mesh from the same state and batch,
    float32, to 1e-5 relative (BatchNorm's sums divided by the count
    against its means)."""
    _need_card()
    import torch.distributed as dist

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.train import steps

    def state_and_batch():
        torch.manual_seed(0)
        if kind == "unet":
            model, tx = models.UNet(base=8), steps.make_optimizer("rmsprop", 1e-3, momentum=0.999, gradient_clipping=1.0)
            gen = torch.Generator().manual_seed(1)
            x, y = torch.rand((8, 64, 64, 3), generator=gen), (torch.rand((8, 64, 64), generator=gen) > 0.5).float()
        else:
            model, tx = models.resnet18(width=16), steps.adam(1e-3)
            x, y = torch.rand((32, 64, 64, 1), generator=torch.Generator().manual_seed(1)), torch.arange(32) % 13
        model = set_compute_dtype(model, torch.float32, master_weights=True).cuda()
        return steps.TrainState.create(model, tx), x.cuda(), y.cuda()

    make = steps.make_seg_train_step if kind == "unet" else steps.make_cls_train_step
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = mesh_lib.create_mesh(device="cuda")
        assert (mesh.size, mesh.backend, mesh.comm_device.type) == (1, "nccl", "cuda")
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
            s1, x, y = state_and_batch()
            m1 = make(mesh)(s1, x, y)
            s0, x, y = state_and_batch()
            m0 = make()(s0, x, y)
    finally:
        dist.destroy_process_group()
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(s1.params, s0.params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_native_packers_bit_identical_on_the_cards_machine() -> None:
    """The port's native loader builds on the card's machine where it has
    libjpeg/libpng headers, and its packers equal the numpy packers."""
    _need_card()
    from chessvision_tpu_torch import engine, native_loader
    from chessvision_tpu_torch.synthetic import board_frames

    built, why = native_loader.build_status()
    if not built and not native_loader.headers_present():
        pytest.skip(f"no libjpeg/libpng headers on this machine: {why}")
    assert built, why
    comp, gray = engine.pack_inputs(board_frames(0, 8)[0])
    for got, want in zip(native_loader.pack_yuv444(comp, gray), engine._pack_yuv444_numpy(comp, gray)):
        assert np.array_equal(got, want)
    for got, want in zip(native_loader.pack_yuv420(comp, gray), engine._pack_yuv420_numpy(comp, gray)):
        assert np.array_equal(got, want)
