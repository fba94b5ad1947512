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


# camera frames: the warp reads the full-resolution gray, so K1 gets source
# rows as wide as the photo.  The first three cases take the fused route
# (``warp_plan``); the short frames below take the two-pass route, whose
# pass 1 stages 2 rows a block at 16 320 floats, one at 40 000, none at
# 60 000 (the photo sizes' pass 1 is held in the test after)
_CAMERA_WARPS = {  # name: (b, h, w)
    "12mp_b2": (2, 3024, 4032),
    "48mp": (1, 6048, 8064),
    "12mp_odd": (1, 3023, 4031),
    "200mp_rows": (1, 40, 16320),
    "one_staged_row": (1, 12, 40000),
    "unstaged_rows": (1, 12, 60000),
}


@pytest.mark.parametrize("case", sorted(_CAMERA_WARPS))
def test_warp_twopass_kernel_matches_plain_at_camera_widths(case) -> None:
    _need_card()
    b, h, w = _CAMERA_WARPS[case]
    rng = np.random.default_rng(sorted(_CAMERA_WARPS).index(case))
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w)).astype(np.float32)).cuda()
    quads = np.stack([_rotated(rng.uniform(-8, 8), 0.6 * min(h, w), 0.5 * w, 0.5 * h)] * b)
    quads[:, :, 0] *= rng.uniform(0.7, 1.3)  # x scaled as the quad of a photo's squashed mask is
    minv = _minv_from_quads(quads, 576, 576)
    before = hat_resample.launches
    got = hat_resample.warp_twopass(imgs, minv, 576, 576)
    torch.cuda.synchronize()
    # one launch a kernel of the route warp_plan names (fused at the photo sizes)
    assert hat_resample.launches == before + _route_launches(b, h, w, 576, 576)
    want = hat_resample.warp_twopass_plain(imgs, minv, 576, 576)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert float(want.abs().max()) > 0


def _route_launches(b: int, h: int, w: int, out_h: int, out_w: int) -> int:
    return len(hat_resample.ROUTE_KERNELS[hat_resample.warp_plan(b, h, w, out_h, out_w)])


# the photos users send (chip_smoke.py's PHOTO_SIZES): both routes against
# the plain version, the fused one through warp_twopass
_PHOTO_SIZES = {"12mp": (3024, 4032), "12mp_portrait": (4032, 3024), "48mp": (6048, 8064), "odd": (3023, 4031)}


@pytest.mark.parametrize("case", sorted(_PHOTO_SIZES))
def test_both_routes_match_plain_at_the_photo_sizes(case) -> None:
    _need_card()
    from chessvision_tpu_torch.synthetic import photo_frames

    h, w = _PHOTO_SIZES[case]
    frames, quads = photo_frames(sorted(_PHOTO_SIZES).index(case), 1, h, w)
    imgs = torch.from_numpy(frames[..., 1].astype(np.float32)).cuda()
    q = quads.astype(np.float64)
    q[:, :, 0] *= h / w  # the engine's quad: x scaled by the height (the reference quirk)
    minv = _minv_from_quads(q, 576, 576)
    assert hat_resample.warp_plan(1, h, w, 576, 576) == "fused"
    want = hat_resample.warp_twopass_plain(imgs, minv, 576, 576)
    before = dict(hat_resample.kernel_launches)
    fused = hat_resample.warp_twopass(imgs, minv, 576, 576)
    torch.cuda.synchronize()
    assert hat_resample.kernel_launches["warp_fused"] == before["warp_fused"] + 1
    assert hat_resample.kernel_launches["warp_pass1"] == before["warp_pass1"]
    assert fused.shape == (1, 576, 576) and fused.is_contiguous()
    torch.testing.assert_close(fused, want, atol=0, rtol=0)
    twopass = hat_resample.warp_pass2(hat_resample.warp_pass1(imgs, minv, 576), minv, 576)
    torch.testing.assert_close(twopass, want, atol=0, rtol=0)
    assert float(want.abs().max()) > 0


def _route_quads(h: int, w: int) -> np.ndarray:
    """tests/test_torch_warp_route.py's quads, without JAX: the photo's,
    the engine's (x scaled by the height), two rotated and one partly
    outside the frame."""
    from chessvision_tpu_torch.synthetic import photo_frames

    photo = photo_frames(h + w, 1, h, w)[1][0].astype(np.float64)
    quirk = photo * [h / w, 1.0]
    return np.stack([photo, quirk, _rotated(30, 0.5 * min(h, w), 0.5 * w, 0.5 * h),
                     _rotated(-25, 0.45 * min(h, w), 0.4 * w, 0.6 * h),
                     _rotated(6, 0.7 * min(h, w), 0.85 * w, 0.8 * h)])


@pytest.mark.parametrize("hw", [(480, 640), (641, 479)], ids=["480x640", "641x479"])
def test_fused_kernel_matches_plain_on_the_cpu_files_quads(hw) -> None:
    _need_card()
    h, w = hw
    rng = np.random.default_rng(h)
    quads = _route_quads(h, w)
    imgs = torch.from_numpy(rng.integers(0, 256, (len(quads), h, w)).astype(np.float32)).cuda()
    for out in (64, 96):
        minv = _minv_from_quads(quads, out, out)
        assert hat_resample.warp_plan(len(quads), h, w, out, out) == "fused"
        got = hat_resample.warp_fused(imgs, minv, out, out)
        torch.testing.assert_close(got, hat_resample.warp_twopass_plain(imgs, minv, out, out), atol=0, rtol=0)
    # the guarded denominator of the CPU file: e − y·h = 0 on row 256, which pass 2 reads
    m = torch.tensor([[1.0, 0.0, 0.0], [4.0, 1.0, 200.0], [0.0, 1.0 / 256.0, 1.0]])
    minv = torch.stack([m, m * 0.5]).cuda()
    got = hat_resample.warp_fused(imgs[:2], minv, 64, 64)
    torch.testing.assert_close(got, hat_resample.warp_twopass_plain(imgs[:2], minv, 64, 64), atol=0, rtol=0)


def test_fused_kernel_at_integer_positions_is_exact() -> None:
    """A 2× downscale samples every output at an integer position: the
    second tap of each axis has weight exactly 0, and the canvas is the
    source's even pixels, bit for bit."""
    _need_card()
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 2400, 2600)).astype(np.float32)).cuda()
    minv = torch.tensor([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 1.0]]).expand(2, 3, 3).contiguous().cuda()
    assert hat_resample.warp_plan(2, 2400, 2600, 576, 576) == "fused"
    got = hat_resample.warp_twopass(imgs, minv, 576, 576)
    torch.testing.assert_close(got, imgs[:, 0:1152:2, 0:1152:2], atol=0, rtol=0)
    torch.testing.assert_close(got, hat_resample.warp_twopass_plain(imgs, minv, 576, 576), atol=0, rtol=0)


def test_fused_route_of_an_empty_batch_launches_nothing() -> None:
    _need_card()
    imgs = torch.zeros((0, 3024, 4032), device="cuda")
    minv = torch.zeros((0, 3, 3), device="cuda")
    before, by_kernel = hat_resample.launches, dict(hat_resample.kernel_launches)
    assert hat_resample.warp_twopass(imgs, minv, 576, 576).shape == (0, 576, 576)
    assert hat_resample.launches == before and hat_resample.kernel_launches == by_kernel


def test_process_image_on_a_48mp_frame() -> None:
    """The facade on an 8064×6048 frame: the K1 launches of its route, a
    result with the segmenter's 256² output, a 512² board where one was
    found."""
    _need_card()
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import photo_frames

    frame = photo_frames(0, 1, 6048, 8064)[0][0]
    before = hat_resample.launches
    res = ChessVision(device="cuda").process_image(frame)
    assert hat_resample.launches == before + _route_launches(1, 6048, 8064, 576, 576)
    assert res.board_extraction.probabilities.shape == (256, 256)
    if res.position is not None:
        assert res.board_extraction.board_image.shape == (512, 512)
        assert len(res.position.fen.split("/")) == 8


def test_warp_twopass_kernel_rejects_noncontiguous_images() -> None:
    _need_card()
    imgs = torch.rand((2, 64, 128), device="cuda")[:, :, ::2]
    minv = torch.eye(3, device="cuda").expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError):
        hat_resample.warp_twopass(imgs, minv, 64, 64)
    with pytest.raises(TypeError):
        hat_resample.warp_twopass(imgs.contiguous().half(), minv, 64, 64)


def test_unkept_variants_equal_kept_kernels(capsys) -> None:
    """The staged pass 2 and the slab-staging warp (``csrc/variants``) build and
    give the kept kernels' floats; the script exits non-zero otherwise."""
    _need_card()
    from chessvision_tpu_torch import k1_variants

    assert k1_variants.main(["--batch", "4"]) == 0
    assert "warp_slab_ms" in capsys.readouterr().out


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


def test_raw_stream_on_a_one_process_mesh_yields_the_mesh_free_tensors_on_the_card() -> None:
    """``Engine(mesh=create_mesh())`` at world size 1 (no process group):
    the raw stream runs each batch mesh-free and yields tensors on the
    card equal to those of the engine without a mesh; ``run_device`` on
    the mesh takes a tensor on the card and returns tensors there."""
    _need_card()
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.parallel.mesh import create_mesh
    from chessvision_tpu_torch.synthetic import board_frames

    frames = board_frames(0, 4)[0]
    batches = [frames[:2], frames[2:]]
    meshed = ChessVision(mesh=create_mesh()).engine
    plain = ChessVision(device="cuda").engine
    got = list(meshed.run_stream(batches, kind="raw"))
    want = list(plain.run_stream(batches, kind="raw"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].is_cuda, k
            assert torch.equal(g[k], w[k]), k
    dev = meshed.run_device(torch.from_numpy(frames).cuda())
    ref = plain.run_device(frames)
    for k in ref:
        assert isinstance(dev[k], torch.Tensor) and dev[k].is_cuda, k
        assert torch.equal(dev[k], ref[k]), k


def test_process_batch_of_no_frames_launches_no_k1_kernel() -> None:
    """At B=0 the engine reaches ``warp_twopass``, whose launchers have no
    element to compute and launch nothing: no K1 launch is counted, and
    every entry returns the JAX package's empty fields on the card."""
    _need_card()
    from chessvision_tpu_torch.core import ChessVision

    engine = ChessVision(device="cuda").engine
    frames0 = np.zeros((0, 512, 512, 3), np.uint8)
    before = hat_resample.launches
    full = engine.process_batch(frames0)
    lite = engine.process_batch(frames0, lite=True)
    dev = engine.run_device(torch.zeros((0, 512, 512, 3), dtype=torch.uint8, device="cuda"))
    (streamed,) = list(engine.run_stream([frames0], kind="raw"))
    torch.cuda.synchronize()
    assert hat_resample.launches == before
    assert full.board_image.shape == (0, 512, 512) and full.board_image.dtype == np.uint8
    assert full.logits.shape == (0, 256, 256) and full.probabilities.shape == (0, 64, 13)
    assert lite.board_image.shape == lite.logits.shape == (0, 0, 0) and lite.fens == full.fens == []
    for out in (dev, streamed):
        assert out["board_image"].is_cuda and out["board_image"].shape == (0, 512, 512)
        assert out["found"].dtype == torch.bool and out["quadrangle"].shape == (0, 4, 2)


_MARGIN_ZERO = r"""
import json
import torch
from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.ops import hat_resample
from chessvision_tpu_torch.synthetic import board_frames

calls = []
kernel = hat_resample.warp_twopass
hat_resample.warp_twopass = lambda *a: calls.append(a) or kernel(*a)
frames = board_frames(0, 4)[0]
res = ChessVision(device="cuda").engine.process_batch(frames)
torch.cuda.synchronize()
launches = hat_resample.launches
(args,) = calls
err = float((kernel(*args) - hat_resample.warp_twopass_plain(*args)).abs().max())
print(json.dumps({"margin": engine_mod._REFINE_MARGIN, "canvas": list(args[2:]), "launches": launches,
                  "err": err, "found": int(res.board_found.sum()), "board": list(res.board_image.shape)}))
"""


def test_process_batch_at_refine_margin_zero_warps_into_the_board() -> None:
    """``CVTPU_REFINE_MARGIN=0`` (read at import, so in a child process):
    the warp goes straight into the 512² board, two K1 launches, the kernel
    equal to its plain version on the call's inputs."""
    _need_card()
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _MARGIN_ZERO], capture_output=True, text=True, timeout=600, cwd=repo,
                         env={**os.environ, "PYTHONPATH": str(repo), "CVTPU_REFINE_MARGIN": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.splitlines()[-1])
    assert rec["margin"] == 0 and rec["canvas"] == [512, 512]
    assert rec["launches"] == 2 and rec["err"] == 0.0
    assert rec["board"] == [4, 512, 512] and rec["found"] > 0


# -- several cards ---------------------------------------------------------------------


def _need_cards(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices and nvcc")


def test_k1_on_every_card_past_the_first_equals_its_plain_version() -> None:
    """Each launch lands on the card of its tensors (``hat_resample._run``'s
    device guard), whatever card is current."""
    _need_cards(2)
    imgs0, minv0, out_h, out_w = _warp_case("rotated")
    for d in range(1, torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        imgs, minv = imgs0.to(dev), minv0.to(dev)
        before = hat_resample.launches
        got = hat_resample.warp_twopass(imgs, minv, out_h, out_w)
        torch.cuda.synchronize(dev)
        assert hat_resample.launches == before + 2 and got.device == dev
        torch.testing.assert_close(got, hat_resample.warp_twopass_plain(imgs, minv, out_h, out_w), atol=0, rtol=0)
        torch.testing.assert_close(got.cpu(), hat_resample.warp_twopass(imgs0, minv0, out_h, out_w).cpu(),
                                   atol=0, rtol=0)


_ENGINE_ON_CARD_1 = r"""
import ctypes, json
import torch

cuda = ctypes.CDLL("libcuda.so.1")
cuda.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
cuda.cuDevicePrimaryCtxGetState.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int)]
assert cuda.cuInit(0) == 0


def contexts():
    active = []
    for i in range(torch.cuda.device_count()):
        dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        assert cuda.cuDeviceGet(ctypes.byref(dev), i) == 0
        assert cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(on)) == 0
        if on.value:
            active.append(i)
    return active


stages = {}
from chessvision_tpu_torch import profiling
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.ops import hat_resample
from chessvision_tpu_torch.synthetic import board_frames

frames = board_frames(0, 4)[0]
x = torch.rand((2, 64, 64), device="cuda:1")
stages["tensor"] = contexts()
hat_resample.warp_twopass(x, torch.eye(3, device="cuda:1").expand(2, 3, 3).contiguous(), 64, 64)
torch.cuda.synchronize(1)
stages["k1"] = contexts()
cv = ChessVision(device="cuda:1")
stages["models"] = contexts()
res = cv.engine.process_batch(frames)
stages["process_batch"] = contexts()
list(cv.engine.run_stream([frames[:2], frames[2:]], kind="raw"))
stages["run_stream"] = contexts()
profiling.wall_ms(cv.engine.process_batch, frames[:1], iters=1, device=cv.engine.device)
stages["wall_ms"] = contexts()
print(json.dumps({"stages": stages, "found": int(res.board_found.sum())}))
"""


def test_an_engine_on_the_second_card_leaves_nothing_on_the_first() -> None:
    """A process that runs ``Engine`` on ``cuda:1`` (a batch, the raw
    stream's pinned buffers, a synchronized timing) holds a context on
    card 1 only, by libcuda's own record."""
    _need_cards(2)
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _ENGINE_ON_CARD_1], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(repo)}, cwd=repo)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(cards == [1] for cards in rec["stages"].values()), rec["stages"]


def _tool_lines(main, argv: list[str], capsys) -> list[dict]:
    import json

    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def _on_the_card(rec: dict) -> None:
    assert rec["backend"] == "cuda" and rec["device"] != "cpu" and "power_limit_w" in rec


def test_bench_quick_on_the_card(capsys) -> None:
    """bench_torch.py --quick: one line, boards found, FENs equal
    process_batch's on its frames, a compute MFU."""
    _need_card()
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.tools import bench

    (rec,) = _tool_lines(bench.main, ["--quick"], capsys)
    _on_the_card(rec)
    frames, _ = bench.bench_frames(4, 0)
    want = ChessVision(device="cuda").engine.process_batch(frames)
    assert rec["boards_found_last_batch"] == int(want.board_found.sum()) > 0
    assert rec["fens_sha256"] == bench.fens_digest(want.fens)
    assert 0 < rec["compute_mfu"] < 1


def test_profile_stages_bench_training_and_sweep_on_the_card(capsys) -> None:
    _need_card()
    from chessvision_tpu_torch.tools import bench_training, profile_stages, sweep_arbitrate_chunk

    before = hat_resample.launches
    (stages,) = _tool_lines(profile_stages.main, ["--batch-size", "8", "--iters", "2"], capsys)
    assert hat_resample.launches > before
    assert all(stages[k] > 0 for k in profile_stages.STAGES) and stages["fused_total"] > 0
    lines = _tool_lines(bench_training.main, ["--quick"], capsys)
    assert [r["trainer"] for r in lines] == ["unet", "classifier"] and all(r["step_ms"] > 0 for r in lines)
    sweeps = [_tool_lines(sweep_arbitrate_chunk.main, ["--batch", "16", "--chunk", str(c), "--iters", "1"], capsys)[0]
              for c in (3, 16)]
    assert sweeps[0]["fens_sha256"] == sweeps[1]["fens_sha256"] and sweeps[0]["boards_found"] > 0
    for rec in [stages, *lines, *sweeps]:
        _on_the_card(rec)


def test_microbench_reports_k1_exact_and_mfu_accounting_on_the_card(capsys) -> None:
    """microbench --which all: K1 bit-exact against its plain version at the
    main path's shapes; mfu_accounting's table on given times."""
    _need_card()
    from chessvision_tpu_torch.tools import mfu_accounting, microbench

    (rec,) = _tool_lines(microbench.main, ["--which", "all", "--iters", "2"], capsys)
    _on_the_card(rec)
    assert rec["warp_max_abs_err"] == 0.0 and 0 < rec["warp_bound_ms"] < rec["warp_twopass_ms"]
    (mfu,) = _tool_lines(mfu_accounting.main, ["--unet-step-ms", "80", "--cls-step-ms", "40",
                                               "--compute-boards-per-sec", "900"], capsys)
    assert mfu["backend"] == "cuda" and [r["peak_share"] > 0 for r in mfu["rows"]] == [True] * 4
    assert mfu["rows"][3]["bound_ms"] == pytest.approx(rec["warp_bound_ms"], rel=1e-12)  # one floor, one input


def _bn_args(shape, in_dtype, residual: bool, relu: bool, out_dtype, layout: str = "nchw"):
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[1]
    x = 3 * torch.randn(shape, generator=g)
    if c % 8:  # the odd map also carries NaN and ±Inf
        x.view(-1)[::97], x.view(-1)[5::101], x.view(-1)[7::103] = float("nan"), float("inf"), -float("inf")
    res = torch.randn(shape, generator=g) if residual else None
    mean, bias = torch.randn(c, generator=g), torch.randn(c, generator=g)
    mul = torch.rsqrt(torch.rand(c, generator=g) + 0.2) * (torch.rand(c, generator=g) + 0.5)
    x = x.cuda().to(in_dtype)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    elif layout == "transposed":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    return (x, mean.cuda(), mul.cuda(), bias.cuda(), None if res is None else res.cuda(), relu, out_dtype)


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "transposed"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32], ids=["bf16_in", "f32_in"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
def test_bn_act_kernel_equals_plain_bit_for_bit(layout, in_dtype, out_dtype, residual) -> None:
    """bn_act at a UNet-like map (32 channels), an odd one (13 channels,
    37×41: a ragged last group of 8) and with NaN and ±Inf, in every
    layout the wrapper takes: the plain version's bits."""
    _need_card()
    from chessvision_tpu_torch.ops import bn_act

    for shape in ((2, 32, 64, 64), (3, 13, 37, 41)):
        for relu in (False, True):
            args = _bn_args(shape, in_dtype, residual, relu, out_dtype, layout)
            before = bn_act.launches
            got = bn_act.bn_act(*args)
            torch.cuda.synchronize()
            assert bn_act.launches == before + 1
            want = bn_act.bn_act_plain(*args)
            assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
            bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits)), (shape, relu)


def test_bn_act_kernel_on_an_empty_map_launches_nothing() -> None:
    _need_card()
    from chessvision_tpu_torch.ops import bn_act

    args = _bn_args((2, 8, 4, 4), torch.bfloat16, False, True, torch.bfloat16)
    before = bn_act.launches
    out = bn_act.bn_act(args[0][:0], *args[1:])
    assert out.shape == (0, 8, 4, 4) and bn_act.launches == before


def test_run_device_at_b1024_fits_and_equals_two_b512_calls() -> None:
    """The JAX package's batch: run_device on 1024 frames on the card, with
    the found flags and FENs of two calls of 512."""
    _need_card()
    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import board_frames
    from chessvision_tpu_torch.tools import memory_peaks
    from chessvision_tpu_torch.tools.bench import assemble_fens

    engine = ChessVision(device="cuda").engine
    frames = torch.from_numpy(board_frames(0, 32)[0]).cuda()
    rec, whole = memory_peaks.peaks(engine, frames, 1024)
    assert whole is not None, rec
    assert 0 < rec["unet_peak_gb"] <= rec["peak_gb"] < 80
    halves = [memory_peaks.peaks(engine, frames, 512)[1] for _ in range(2)]
    names = constants.SQUARE_NAMES_NORMAL
    assert torch.equal(whole["found"].cpu(), torch.cat([h["found"] for h in halves]).cpu())
    assert assemble_fens(whole, names) == assemble_fens(halves[0], names) + assemble_fens(halves[1], names)


# -- the test-set tools ----------------------------------------------------------------


def _gate_cli(*args: str, timeout: int = 600) -> tuple[int, dict]:
    """``python -m chessvision_tpu_torch.tools.drift_gate ARGS``: (exit code,
    its last printed JSON line)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-m", "chessvision_tpu_torch.tools.drift_gate", *args],
                          cwd=repo, capture_output=True, text=True, timeout=timeout)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    return proc.returncode, json.loads(lines[-1]) if lines else {"stdout": proc.stdout[-2000:], "stderr": proc.stderr[-2000:]}


def test_drift_gate_holds_the_card_to_cpu_goldens_of_a_synthetic_root(tmp_path) -> None:
    """CPU goldens of four seeded 512² frames, then the gate on the card:
    found flags identical and every board within the JAX gate's 3 squares;
    the command line, at the JAX gate's 35-exact floor, fails on four
    images with exit 1 (not the skip's 42)."""
    _need_card()
    from chessvision_tpu_torch.synthetic import write_test_root
    from chessvision_tpu_torch.tools import drift_gate, make_fen_goldens

    root = write_test_root(tmp_path / "test", 4, seed=15)
    goldens = tmp_path / "goldens.json"
    make_fen_goldens.main(["--test-root", str(root), "--out", str(goldens)])
    summary, got = drift_gate.gate(goldens, root, max_square_diff=3, min_exact=0)
    assert (summary["backend"], summary["images"], len(got)) == ("cuda", 4, 4)
    assert summary["failures"] == [], summary
    rc, printed = _gate_cli("--goldens", str(goldens), "--test-root", str(root))
    assert rc == 1, printed
    assert printed["failures"][-1] == f"only {summary['exact']}/4 exact FEN matches (floor 35)"
    assert {k: printed[k] for k in summary} == {**summary, "failures": printed["failures"]}
    assert printed["device"] and "power_limit_w" in printed


def test_drift_gate_fails_on_a_test_root_without_images_on_the_card(tmp_path) -> None:
    _need_card()
    (tmp_path / "batch0" / "raw").mkdir(parents=True)
    rc, _ = _gate_cli("--test-root", str(tmp_path))
    assert rc not in (0, 42)


@pytest.mark.slow
def test_card_fens_within_band_of_the_committed_cpu_goldens() -> None:
    """The counterpart of tests/test_tpu_drift.py: the gate's defaults, the
    JAX package's committed CPU goldens over ``data/test`` (identical found
    flags, ≤ 3 squares a board, ≥ 35 exact)."""
    from chessvision_tpu_torch import constants

    if not (constants.data_root() / "test").is_dir():
        pytest.skip("data/test (the test photos the goldens name) is absent")
    rc, summary = _gate_cli(timeout=3000)
    if rc == 42:
        pytest.skip("no CUDA device")
    assert rc == 0, f"the card's FENs left the band of the CPU goldens: {summary}"
    assert summary["exact"] >= 35


# -- negatively strided frames, threads, the graft entry (the CPU cases: tests/test_torch_input_layouts.py,
#    tests/test_torch_threads.py, tests/test_torch_graft_entry.py) -----------------------------------


def test_pinned_raw_stream_takes_negatively_strided_frames() -> None:
    """``run_stream(kind="raw")`` on the card stages each batch through its
    pinned buffers: channel-reversed, mirrored and batch-reversed views
    give ``run_device``'s outputs on their contiguous copies, bit for bit."""
    _need_card()
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import board_frames

    frames = board_frames(0, 4)[0]
    views = [frames[..., ::-1], np.flip(frames, 2), frames[::-1]]
    assert all(any(s < 0 for s in v.strides) for v in views)
    engine = ChessVision(device="cuda").engine
    got = list(engine.run_stream(views, kind="raw"))
    assert len(got) == 3
    for g, v in zip(got, views):
        want = engine.run_device(np.ascontiguousarray(v))
        for k in want:
            assert g[k].is_cuda and torch.equal(g[k], want[k]), k


def test_two_threads_on_12mp_frames_keep_tf32_off_in_the_resize() -> None:
    """Two threads call ``process_batch`` on 12 MP frames at once, with the
    caller's TF32 flags on: the front half's matmul resize of every call
    (``comp``) equals, bit for bit, one thread's in full float32 on the card
    (which TF32 moves in ~1 000 pixels a frame), and the flags come back
    on.  One thread's result is held to the CPU's too, within one pixel a
    frame: on an H100 frame 0 differs in one pixel, a box sum that a
    rounding puts on the other side of .5 (the card sums in another
    order), and the other frames nowhere."""
    _need_card()
    import threading

    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import photo_frames
    from chessvision_tpu_torch.utils import full_f32

    frames = photo_frames(3, 4, 3024, 4032)[0]
    cpu = [engine_mod.preprocess_images(torch.from_numpy(f[None]))[0] for f in frames]
    with torch.inference_mode(), full_f32():
        want = [engine_mod.preprocess_images(torch.from_numpy(f[None]).cuda())[0].cpu() for f in frames]
    assert max(int((w != c).sum()) for w, c in zip(want, cpu)) <= 1
    engine = ChessVision(device="cuda").engine
    engine.process_batch(frames[:1])  # warm-up
    real = engine_mod.preprocess_images
    seen: list = []

    def recording(images):
        comp, gray = real(images)
        seen.append((threading.get_ident(), images[0, ::97, ::89].cpu(), comp.cpu()))
        return comp, gray

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    errors: list = []
    go = threading.Barrier(2)

    def work(rows) -> None:
        try:
            go.wait(30)
            for _ in range(3):
                for i in rows:
                    engine.process_batch(frames[i:i + 1])
        except Exception as e:  # reported by the main thread
            errors.append(e)

    engine_mod.preprocess_images = recording
    try:
        with torch.inference_mode():
            tf32 = real(torch.from_numpy(frames[:1]).cuda())[0].cpu()
        threads = [threading.Thread(target=work, args=(rows,)) for rows in ((0, 1), (2, 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        engine_mod.preprocess_images = real
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert not errors, errors
    assert after == (True, True)
    assert int((tf32 != want[0]).sum()) > 100  # what a TF32 resize would change
    assert len(seen) == 12 and len({s[0] for s in seen}) == 2
    for _, sample, comp in seen:
        i = next(i for i, f in enumerate(frames) if torch.equal(torch.from_numpy(f[::97, ::89]), sample))
        assert torch.equal(comp, want[i]), (i, int((comp != want[i]).sum()))


def test_graft_entry_on_the_card() -> None:
    """``graft_entry_torch.entry()`` on the card: its outputs' layout and
    K1's and ``bn_act``'s launches of one call; ``dryrun_multichip(1)``."""
    _need_card()
    import graft_entry_torch as graft
    from chessvision_tpu_torch.ops import bn_act

    fn, (images, threshold) = graft.entry(batch=2)
    fn(images, threshold)
    torch.cuda.synchronize()
    before_k1, before_bn = hat_resample.launches, bn_act.launches
    out = fn(images, threshold)
    torch.cuda.synchronize()
    assert hat_resample.launches - before_k1 == 2 and bn_act.launches - before_bn == 58
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in out.items()} == {
        "logits": ((2, 256, 256), torch.float32, "cuda"), "quadrangle": ((2, 4, 2), torch.float32, "cuda"),
        "found": ((2,), torch.bool, "cuda"), "board_image": ((2, 512, 512), torch.uint8, "cuda"),
        "probabilities": ((2, 64, 13), torch.float32, "cuda"),
    }
    (rec,) = graft.dryrun_multichip(1)
    assert rec["device"] == "cuda:0" and rec["engine_batch"] == [1, 64, 13]
    assert np.isfinite(rec["seg_loss"]) and np.isfinite(rec["cls_loss"])
