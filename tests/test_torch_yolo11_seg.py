"""The port's YOLO11-seg extractor (``models/yolo11_seg.py``) and the
``bn_act`` epilogues it runs, on the CPU.

- At scale n (depth 0.5, width 0.25) on seeded leaves, float32, B=2 at 64²
  and 128²: the raw head outputs (P3, P4 and P5 box bins, class logits and
  coefficients, the prototypes) against ``tests/_yolo11_plain.py``, a plain
  eager copy with its own leaf loader, to 1e-5 relative L2 (about 30 float32
  layers whose convolutions sum in another order, SiLU as ``F.silu``
  against ``t / (1 + exp(−t))``: 0.9–2.2e-6 was measured), and the contract logits where both pick
  the same anchor (the mask is 32 products that cancel: the same pixels
  kept and values within 1e-5 of the products' largest magnitude sum,
  but where the reference's map lies within that of 0);
- the top-1 and mask assembly against a literal transcription of
  Ultralytics' ``crop_mask`` / ``process_mask`` on hand-made head outputs: a
  box partly off the frame, a tie between anchors, a score exactly at
  0.25, no detection;
- ``bn_act``'s SiLU and post-activation residual epilogues against their
  formula, with float32 and bf16 residuals, and the residual layouts the
  kernel reads in place;
- scale s at 256², B=1: shapes, parameter count, one SiLU ``bn_act`` call
  per SiLU BatchNorm and no ``F.batch_norm``;
- the facade: ``yolo11_seg`` without weights builds from seed 0 (never
  another model's checkpoint), and from a checkpoint takes its
  architecture from ``training_config``; a process_batch through the
  engine, which runs it (and not the UNet) through its CUDA graphs'
  wrapper, eager off the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _yolo11_plain import PlainYolo11Seg, contract_logits, seeded_leaves, top_detection, upsampled_mask
from chessvision_tpu_torch import constants, models
from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.checkpoint import save_checkpoint
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.models import layers
from chessvision_tpu_torch.models import yolo11_seg as Y
from chessvision_tpu_torch.models.layers import BatchNorm2d
from chessvision_tpu_torch.ops import bn_act as bn_mod
from chessvision_tpu_torch.weights import flax_to_torch, torch_to_flax

SCALE_N = {"depth": 0.5, "width": 0.25, "max_channels": 1024, "nc": 1}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def scale_n():
    """(the port's scale-n model, the plain copy), the same seeded leaves.
    Kernels at 2.4 / fan-in: at He's 2 the SiLU maps fade to the BatchNorm
    biases within the ~30 layers, every frame gives the same top anchor and
    its mask is empty; at 2.4 the frames' top anchors differ and their
    masks cover 1–6% of the frame (at 2.8 and over the maps grow, and with
    them the float32 error, past 1e-5)."""
    model, _ = models.create_extractor("yolo11_seg", **SCALE_N)
    shapes = {k: v.shape for k, v in _flat(torch_to_flax(model)).items()}
    flat = seeded_leaves(shapes, 12, gain=2.4)
    model.load_state_dict(flax_to_torch(_tree(flat), model))
    return model.eval(), PlainYolo11Seg(flat)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


@pytest.mark.parametrize("size", [64, 128])
def test_head_outputs_and_logits_match_the_plain_copy(scale_n, size) -> None:
    model, plain = scale_n
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(size))
    with torch.inference_mode():
        raw = model.capturable(x)
        logits = model(x)[..., 0]
    want = plain.head(x)
    for got_level, want_level in zip(raw["levels"], want["levels"]):
        assert got_level.shape == want_level.shape
        for part in (slice(0, 64), slice(64, 65), slice(65, 97)):  # box bins, class, coefficients
            assert _rel(got_level[:, part], want_level[:, part]) < 1e-5
    assert raw["protos"].shape == (2, 32, size // 4, size // 4) and raw["protos"].dtype == torch.float32
    assert _rel(raw["protos"], want["protos"]) < 1e-5
    top_got = top_detection([t.float() for t in raw["levels"]])[0]
    top_want = top_detection(want["levels"])[0]
    assert len(set(top_want.tolist())) == 2
    want_logits = plain.logits(x)
    _, _, boxes, coeffs = top_detection(want["levels"])
    kept = 0
    for i in torch.nonzero(top_got == top_want)[:, 0].tolist():
        protos = want["protos"][i].flatten(1)
        # the mask is a sum of 32 products that cancel: its error is bounded
        # by the products' magnitudes times the inputs' relative error
        bound = 1e-5 * float((coeffs[i].abs() @ protos.abs()).max())
        up = upsampled_mask(want["protos"][i], coeffs[i : i + 1], boxes[i : i + 1], (size, size))[0]
        got_on, want_on = logits[i] > 0, want_logits[i] > 0
        assert ((got_on == want_on) | (up.abs() <= bound)).all()
        both = got_on & want_on
        assert float((logits[i][both] - want_logits[i][both]).abs().max()) <= bound
        assert (logits[i][~got_on] == Y.OFF_LOGIT).all() and (want_logits[i][~want_on] == Y.OFF_LOGIT).all()
        kept += int(both.sum())
    assert kept > 0
    assert logits.shape == (2, size, size) and logits.dtype == torch.float32


def _levels(size: int, seed: int) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Hand-made raw head outputs of one class at input ``size``: box bins,
    class logits well under conf, coefficients, and the prototypes."""
    g = torch.Generator().manual_seed(seed)
    levels = []
    for s in Y.STRIDES:
        n = size // s
        t = torch.randn((2, 97, n, n), generator=g)
        t[:, 64] = -6.0
        levels.append(t)
    return levels, torch.randn((2, 32, size // 4, size // 4), generator=g)


def _set(levels: list[torch.Tensor], frame: int, anchor: int, logit: float, bins: torch.Tensor | None = None) -> None:
    """Write the class logit (and the box bins) of a flat anchor index."""
    for t in levels:
        a = t.shape[2] * t.shape[3]
        if anchor < a:
            flat = t[frame].view(97, a)
            flat[64, anchor] = logit
            if bins is not None:
                flat[:64, anchor] = bins
            return
        anchor -= a


def _assembled(levels, protos, size):
    segment = Y.Segment(1, 32, 16, (16, 32, 64))
    with torch.inference_mode():
        return segment.assemble({"levels": levels, "protos": protos}, (size, size))[..., 0]


def test_top1_mask_against_ultralytics_process_mask() -> None:
    size = 64
    levels, protos = _levels(size, 0)
    # frame 0: the top anchor on P4 at (1, 2), its box sharply 3 bins left
    # and up (past the frame) and 1 right and down
    bins = torch.full((4, 16), -30.0)
    for side, j in enumerate((3, 3, 1, 1)):
        bins[side, j] = 30.0
    _set(levels, 0, 64 + 1 * 4 + 2, 2.0, bins.flatten())
    # frame 1: two anchors tie on the top score; the first index wins
    _set(levels, 1, 10, 3.0)
    _set(levels, 1, 70, 3.0)
    got = _assembled(levels, protos, size)
    want = contract_logits(levels, protos, (size, size))
    top, _, boxes, _ = top_detection(levels)
    assert top.tolist() == [70, 10]
    assert boxes[0].tolist() == [-8.0, -24.0, 56.0, 40.0]  # partly off the frame
    # the same pixels kept; the mask product sums in another order
    assert torch.equal(got > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert (got[0] > 0).any() and (got[0] < 0).any() and (got[1] > 0).any()


def test_a_score_at_conf_and_no_detection_give_no_mask() -> None:
    size = 64
    levels, protos = _levels(size, 1)
    # a float32 logit whose sigmoid is 0.25 exactly: not over conf
    x = torch.tensor(-1.0986123, dtype=torch.float32)
    _set(levels, 0, 5, float(x))
    assert top_detection(levels)[1][0] == 0.25
    got = _assembled(levels, protos, size)
    assert torch.equal(got, contract_logits(levels, protos, (size, size)))
    assert (got == Y.OFF_LOGIT).all()  # frame 0 at conf, frame 1 all under
    above = torch.nextafter(x, torch.tensor(0.0))
    _set(levels, 0, 5, float(above))
    assert top_detection(levels)[1][0] > 0.25
    got = _assembled(levels, protos, size)
    want = contract_logits(levels, protos, (size, size))
    assert torch.equal(got > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert (got[0] != Y.OFF_LOGIT).any() and (got[1] == Y.OFF_LOGIT).all()


def _bn_args(shape, seed, res_dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = 4 * torch.randn(shape, generator=g)
    mean, bias = torch.randn(c, generator=g), torch.randn(c, generator=g)
    mul = torch.rand(c, generator=g) + 0.5
    res = torch.randn(shape, generator=g).to(res_dtype)
    return x, mean, mul, bias, res


@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16], ids=["f32_res", "bf16_res"])
def test_bn_act_silu_and_post_residual_follow_their_formula(res_dtype) -> None:
    x, mean, mul, bias, res = _bn_args((2, 16, 5, 7), 3, res_dtype)
    t = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    silu = t / (1 + torch.exp(-t))
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, None, "silu"), silu)
    np.testing.assert_allclose(silu.numpy(), F.silu(t).numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, res, "silu+res"), silu + res.float())
    pre = t + res.float()
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, res, "silu"), pre / (1 + torch.exp(-pre)))
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, res, "none"), t + res.float())
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, res.float(), "relu"), (t + res.float()).relu())
    assert torch.equal(bn_mod.bn_act(x, mean, mul, bias, None), t)
    out = bn_mod.bn_act(x, mean, mul, bias, res, "silu+res", torch.bfloat16)
    assert torch.equal(out, (silu + res.float()).to(torch.bfloat16))
    with pytest.raises(ValueError, match="epilogue"):
        bn_mod.bn_act(x, mean, mul, bias, None, "gelu")
    with pytest.raises(ValueError, match="epilogue"):
        bn_mod.bn_act(x, mean, mul, bias, None, True)  # a name, not a flag


def test_batchnorm_act_silu_epilogues_in_train_and_inference() -> None:
    x, mean, _, bias, res = _bn_args((2, 8, 4, 4), 4)
    bn = BatchNorm2d(8, eps=1e-3)
    with torch.no_grad():
        bn.running_mean.copy_(mean)
        bn.running_var.uniform_(0.5, 1.5)
        bn.bias.copy_(bias)
    bn.eval()
    with torch.no_grad():
        fast = bn.act(x, "silu+res", res)
    slow = bn.act(x, "silu+res", res)  # a gradient through frozen statistics: the float32 ops
    np.testing.assert_allclose(fast.numpy(), slow.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(slow.detach(), F.silu(bn(x)).detach() + res)


def test_residual_slices_are_read_in_place() -> None:
    """The dense kernel's residual blocks: a dense map is one block, a
    channel half of an NCHW map one block a batch item, of an NHWC map one
    a pixel; a layout it cannot read in blocks goes to the strided kernel."""
    nchw = torch.empty((4, 64, 8, 8))
    nhwc = torch.empty((4, 64, 8, 8), memory_format=torch.channels_last)
    cl, cf = torch.channels_last, torch.contiguous_format
    n = 4 * 32 * 64
    assert bn_mod._residual_blocks(nchw[:, :32].contiguous(), cf) == (n, n)
    assert bn_mod._residual_blocks(nchw[:, 32:], cf) == (32 * 64, 64 * 64)
    assert bn_mod._residual_blocks(nhwc[:, 32:], cl) == (32, 64)
    assert bn_mod._residual_blocks(nhwc[:, 32:], cf) is None
    assert bn_mod._residual_blocks(nchw[:, 4:8], cl) is None
    assert bn_mod._residual_blocks(nhwc[:, 4:8], cl) is None  # 4 channels: under one 16-byte load a block
    one = torch.empty((1, 64, 1, 1))
    assert bn_mod._residual_blocks(one[:, 32:], cl) == (32, 32)


def test_scale_s_forward_shapes_params_and_bn_act_calls(monkeypatch) -> None:
    torch.manual_seed(0)
    model, spec = models.create_extractor("yolo11_seg")
    assert spec.input_size == (256, 256) and spec.in_channels == 3
    assert sum(p.numel() for p in model.parameters()) == 10_082_659
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    convs = [m for m in model.modules() if isinstance(m, Y.Conv)]
    silu_bns = sum(c.silu for c in convs)
    assert len(bns) == len(convs) == 90 and silu_bns == 86
    assert sum(c.conv.groups > 1 for c in convs) == 7
    calls, real = [], layers.bn_act

    def recording(x, mean, mul, bias, residual, act, out_dtype):
        calls.append(act)
        return real(x, mean, mul, bias, residual, act, out_dtype)

    def no_batch_norm(*a, **k):
        raise AssertionError("F.batch_norm called")

    monkeypatch.setattr(layers, "bn_act", recording)
    monkeypatch.setattr(F, "batch_norm", no_batch_norm)
    x = torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        raw = model.eval().capturable(x)
        logits = model(x)
    assert [tuple(t.shape) for t in raw["levels"]] == [(1, 97, 32, 32), (1, 97, 16, 16), (1, 97, 8, 8)]
    assert raw["protos"].shape == (1, 32, 64, 64)
    assert logits.shape == (1, 256, 256, 1) and logits.dtype == torch.float32
    per_forward = calls[: len(calls) // 2]
    assert len(per_forward) == 90
    assert sum(a in ("silu", "silu+res") for a in per_forward) == silu_bns
    # the Bottlenecks: one in each C3k2 of layers 2, 4, 13, 16, 19, two in the C3k of 6, 8, 22
    assert per_forward.count("silu+res") == 11


def test_facade_builds_yolo11_seg_from_seed_zero_or_from_its_checkpoint(tmp_path) -> None:
    cv = ChessVision(board_extractor_model_id="yolo11_seg", device="cpu", dtype=torch.float32)
    assert cv._board_extractor_weights is None
    unet_cv = ChessVision(device="cpu")
    assert unet_cv._board_extractor_weights == constants.BEST_EXTRACTOR_WEIGHTS
    # the engine runs only an extractor with a capturable stage through its graphs
    assert unet_cv.engine._extractor is unet_cv.board_extractor[0]
    assert isinstance(cv.engine._extractor, engine_mod._GraphedExtractor)
    assert ChessVision(board_extractor_model_id="yolo", device="cpu")._board_extractor_weights == \
        constants.BEST_YOLO_EXTRACTOR
    built, spec = cv.board_extractor
    assert spec.model_id == "yolo11_seg"
    torch.manual_seed(0)
    want, _ = models.create_extractor("yolo11_seg")
    for (k, a), (_, b) in zip(built.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k
    # a checkpoint of scale n: its training_config sets the architecture
    small, _ = models.create_extractor("yolo11_seg", **SCALE_N)
    path = tmp_path / "yolo11n.npz"
    save_checkpoint(path, torch_to_flax(small), {"training_config": {**SCALE_N, "model_id": "yolo11_seg"}})
    cv = ChessVision(board_extractor_weights=str(path), board_extractor_model_id="yolo11_seg", device="cpu",
                     dtype=torch.float32)
    loaded, _ = cv.board_extractor
    assert sum(p.numel() for p in loaded.parameters()) == sum(p.numel() for p in small.parameters())
    for (k, a), (_, b) in zip(loaded.state_dict().items(), small.state_dict().items()):
        assert torch.equal(a, b), k
    frames = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    out = cv.engine.process_batch(frames)
    assert out.logits.shape == (1, 256, 256) and len(out.fens) == 1
