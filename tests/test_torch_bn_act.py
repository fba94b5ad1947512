"""The inference BatchNorm pass (``ops/bn_act.py``) and the models that use
it, against Flax and the JAX models, on the CPU.

- ``bn_act_plain`` against Flax's ``nn.BatchNorm(use_running_average=True)``
  + residual + ``nn.relu`` on the same seeded inputs: bit for bit given
  Flax's ``mul`` (the order of operations is Flax's), and within rtol/atol
  1e-6 with the port's own ``mul``, whose ``torch.rsqrt`` and XLA's rsqrt
  round some channels' factors apart;
- the eval UNet (base 8, and its bilinear variant) and a ResNet18 of width
  16 at batch ≤ 4: the one-pass path, whose maps a convolution alone reads
  are stored in the convolutions' dtype, bit for bit against the same
  arithmetic with every map stored in float32 (rounding commutes with max
  pooling, concatenation and the convolution's own cast); against the
  eval path of ``F.batch_norm`` (another order: float32 within 2e-5, bf16
  probabilities within 0.02); against the JAX models at float32 under
  ``test_torch_models.py``'s tolerances (logits and features atol 2e-3,
  probabilities 1e-5);
- ``BatchNorm2d.act`` keeps the train path and the gradient through frozen
  statistics; its cached factor follows the statistics;
- ``Engine.process_batch`` at B=2, float32 with the committed weights,
  against the JAX engine: found flags, FENs, quads within 1e-3 px.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chessvision_tpu.models.resnet import resnet18 as flax_resnet18
from chessvision_tpu.models.unet import UNet as FlaxUNet
from chessvision_tpu_torch.models import layers
from chessvision_tpu_torch.models.layers import BatchNorm2d, set_compute_dtype
from chessvision_tpu_torch.models.resnet import resnet18
from chessvision_tpu_torch.models.unet import UNet
from chessvision_tpu_torch.ops import bn_act as bn_mod
from chessvision_tpu_torch.weights import torch_to_flax

EPS = 1e-5


def _bn_inputs(seed: int, shape=(2, 5, 7, 9)):
    rng = np.random.default_rng(seed)
    c = shape[1]
    return {
        "x": (3 * rng.normal(size=shape)).astype(np.float32),
        "mean": rng.normal(size=c).astype(np.float32),
        "var": rng.uniform(0.2, 2.0, c).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(size=c).astype(np.float32),
        "res": rng.normal(size=shape).astype(np.float32),
    }


def _flax_bn(d: dict, x: np.ndarray, residual: bool, relu: bool) -> np.ndarray:
    bn = fnn.BatchNorm(use_running_average=True, epsilon=EPS, dtype=jnp.float32)
    v = {"params": {"scale": d["scale"], "bias": d["bias"]}, "batch_stats": {"mean": d["mean"], "var": d["var"]}}
    y = bn.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    if residual:
        y = y + jnp.asarray(d["res"].transpose(0, 2, 3, 1))
    if relu:
        y = fnn.relu(y)
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_plain_matches_flax(in_dtype, residual, relu) -> None:
    d = _bn_inputs(0)
    act = "relu" if relu else "none"
    x = torch.from_numpy(d["x"]).to(in_dtype)
    want = _flax_bn(d, x.float().numpy(), residual, relu)  # bf16 values are exact in float32
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    res = t["res"] if residual else None
    # Flax's own factor: the same floats, bit for bit
    flax_mul = torch.from_numpy(np.array(jax.lax.rsqrt(jnp.asarray(d["var"]) + EPS) * d["scale"]))
    np.testing.assert_array_equal(bn_mod.bn_act_plain(x, t["mean"], flax_mul, t["bias"], res, act).numpy(), want)
    # the port's factor (torch.rsqrt), rounded apart from XLA's on some channels
    mul = torch.rsqrt(t["var"] + EPS) * t["scale"]
    got = bn_mod.bn_act(x, t["mean"], mul, t["bias"], res, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # stored in bf16: the float32 result rounded once
    got16 = bn_mod.bn_act(x, t["mean"], mul, t["bias"], res, act, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_bn_act_cpu_layouts_and_checks() -> None:
    d = _bn_inputs(1, (3, 6, 5, 4))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    mul = torch.rsqrt(t["var"] + EPS) * t["scale"]
    before = bn_mod.launches
    want = bn_mod.bn_act(t["x"], t["mean"], mul, t["bias"], t["res"], "relu")
    # a transposed view and a channels-last map give the same values
    xt = t["x"].transpose(2, 3).contiguous().transpose(2, 3)
    assert not xt.is_contiguous()
    assert torch.equal(bn_mod.bn_act(xt, t["mean"], mul, t["bias"], t["res"], "relu"), want)
    xc = t["x"].to(memory_format=torch.channels_last)
    assert torch.equal(bn_mod.bn_act(xc, t["mean"], mul, t["bias"], t["res"], "relu"), want)
    # NaN and Inf pass through as torch's ops pass them
    x = t["x"].clone()
    x[0, 0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    got = bn_mod.bn_act(x, t["mean"], mul, t["bias"], None, "relu")
    assert torch.isnan(got[0, 0, 0, 0]) and got[0, 0, 0, 1] == float("inf") and got[0, 0, 0, 2] == 0
    empty = bn_mod.bn_act(t["x"][:0], t["mean"], mul, t["bias"])
    assert empty.shape == (0, 6, 5, 4)
    assert bn_mod.launches == before  # the CPU launches no kernel
    with pytest.raises(TypeError):
        bn_mod.bn_act(t["x"].double(), t["mean"], mul, t["bias"])
    with pytest.raises(ValueError):
        bn_mod.bn_act(t["x"], t["mean"][:5], mul, t["bias"])
    with pytest.raises(ValueError):
        bn_mod.bn_act(t["x"], t["mean"], mul, t["bias"], t["res"][:1])
    # meta tensors (the FLOP counts' shapes-only runs) take the plain version's shapes
    meta = bn_mod.bn_act(t["x"].to("meta"), t["mean"].to("meta"), mul.to("meta"), t["bias"].to("meta"),
                         out_dtype=torch.bfloat16)
    assert meta.is_meta and meta.shape == t["x"].shape and meta.dtype == torch.bfloat16


# -- the models -----------------------------------------------------------------------------


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and running statistic from a numpy generator, so
    that each BatchNorm does real work."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            state[k] = v
        elif k.endswith("running_var"):
            state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith("running_mean"):
            state[k] = torch.from_numpy((0.1 * rng.normal(size=v.shape)).astype(np.float32))
        elif v.ndim == 1:  # BatchNorm weight and bias, conv and fc biases
            lo, hi = (0.5, 1.5) if k.split(".")[-2].startswith(("bn", "down_bn")) and k.endswith("weight") else (-0.1, 0.1)
            state[k] = torch.from_numpy(rng.uniform(lo, hi, v.shape).astype(np.float32))
        else:
            fan_in = v[0].numel()
            state[k] = torch.from_numpy((rng.normal(size=v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
    model.load_state_dict(state)
    return model.eval()


def _models(dtype: torch.dtype):
    return {
        "unet": set_compute_dtype(_seeded(UNet(3, 1, base=8), 0), dtype),
        "unet_bilinear": set_compute_dtype(_seeded(UNet(3, 1, base=8, bilinear=True), 1), dtype),
        "resnet18": set_compute_dtype(_seeded(resnet18(width=16), 2), dtype),
    }


def _input(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    shape = (4, 64, 64, 1) if name == "resnet18" else (2, 32, 32, 3)
    return rng.random(shape).astype(np.float32)


def _float32_maps(monkeypatch) -> None:
    """The one-pass arithmetic with every map stored in float32 (the
    storage of the eager path before the kernel)."""
    real = bn_mod.bn_act

    def wide(x, mean, mul, bias, residual=None, act="none", out_dtype=torch.float32):
        return real(x, mean, mul, bias, residual, act, torch.float32)

    monkeypatch.setattr(layers, "bn_act", wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["unet", "unet_bilinear", "resnet18"])
def test_inference_path_equals_float32_stored_maps(name, dtype, monkeypatch) -> None:
    model = _models(dtype)[name]
    x = torch.from_numpy(_input(name))
    calls = []
    real = layers.bn_act

    def recording(x_, *args, **kw):
        out = real(x_, *args, **kw)
        calls.append(out.dtype)
        return out

    monkeypatch.setattr(layers, "bn_act", recording)
    with torch.inference_mode():
        logits, feats = model(x, return_features=True)
    bns = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    assert len(calls) == bns  # every BatchNorm once, through bn_act
    if dtype == torch.bfloat16:  # the maps only convolutions read are bf16
        assert torch.bfloat16 in calls and torch.float32 in calls
    else:
        assert set(calls) == {torch.float32}
    monkeypatch.setattr(layers, "bn_act", real)
    _float32_maps(monkeypatch)
    with torch.inference_mode():
        logits32, feats32 = model(x, return_features=True)
    assert logits.dtype == feats.dtype == torch.float32
    assert torch.equal(logits, logits32) and torch.equal(feats, feats32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["unet", "unet_bilinear", "resnet18"])
def test_inference_path_against_batch_norm_order(name, dtype) -> None:
    """Flax's order against ``F.batch_norm``'s (the eval path with a
    gradient enabled): float32 logits within 2e-5, probabilities within
    1e-5; bf16 rounds the few floats that moved to another bf16 value and
    the convolutions carry it on: probabilities within 0.02."""
    model = _models(dtype)[name]
    x = torch.from_numpy(_input(name))
    with torch.inference_mode():
        new = model(x)
    old = model(x).detach()
    prob = torch.softmax if name == "resnet18" else (lambda t, dim: torch.sigmoid(t))
    if dtype == torch.float32:
        np.testing.assert_allclose(new.numpy(), old.numpy(), atol=2e-5)
        np.testing.assert_allclose(prob(new, dim=-1).numpy(), prob(old, dim=-1).numpy(), atol=1e-5)
    else:
        np.testing.assert_allclose(prob(new, dim=-1).numpy(), prob(old, dim=-1).numpy(), atol=0.02)


@pytest.mark.parametrize("name", ["unet", "unet_bilinear", "resnet18"])
def test_inference_path_matches_jax(name) -> None:
    model = _models(torch.float32)[name]
    x = _input(name)
    if name == "resnet18":
        flax_model = flax_resnet18(width=16, dtype=jnp.float32)
    else:
        flax_model = FlaxUNet(base=8, bilinear=name == "unet_bilinear", dtype=jnp.float32)
    want_logits, want_feats = flax_model.apply(torch_to_flax(model), jnp.asarray(x), return_features=True)
    with torch.inference_mode():
        logits, feats = model(torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=2e-3)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=2e-3)
    if name == "resnet18":
        np.testing.assert_allclose(torch.softmax(logits, -1).numpy(),
                                   np.asarray(jax.nn.softmax(want_logits, -1)), atol=1e-5)


def test_batchnorm_act_keeps_train_path_and_gradient() -> None:
    rng = np.random.default_rng(3)
    bn = BatchNorm2d(4)
    bn.weight.data = torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 4, 3, 3)).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=(2, 4, 3, 3)).astype(np.float32))
    # train mode: the batch statistics and today's float32 ops
    bn.train()
    got = bn.act(x, residual=res, out_dtype=torch.bfloat16)
    ref = BatchNorm2d(4)
    ref.load_state_dict(bn.state_dict())
    ref.running_mean.zero_()
    ref.running_var.fill_(1.0)
    ref.train()
    assert got.dtype == torch.float32
    assert torch.equal(got, F.relu(ref(x) + res))
    # a gradient through frozen statistics: F.batch_norm's eval path, differentiable
    bn.eval()
    xg = x.clone().requires_grad_(True)
    y = bn.act(xg)
    want = F.relu(F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps))
    assert torch.equal(y.detach(), want)
    y.sum().backward()
    assert xg.grad is not None and bn.weight.grad is not None
    # inference: the factor is made once and follows the statistics
    with torch.no_grad():
        first = bn.act(x)
        mul = bn._mul
        assert bn.act(x) is not first and bn._mul is mul
        bn.running_var.mul_(4.0)
        moved = bn.act(x)
    assert bn._mul is not mul
    np.testing.assert_allclose(moved.numpy(), bn_mod.bn_act_plain(
        x, bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight.detach(), bn.bias.detach(),
        act="relu").numpy(), rtol=0, atol=0)


# -- the engine -----------------------------------------------------------------------------


def test_process_batch_b2_matches_jax_engine() -> None:
    from chessvision_tpu.core import ChessVision as JaxChessVision
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import board_frames

    frames, _ = board_frames(1, 2)
    want = JaxChessVision(dtype=jnp.float32, refine_grid="arbitrate").engine.process_batch(frames)
    got = ChessVision(dtype=torch.float32, device="cpu").engine.process_batch(frames)
    assert want.board_found.any()
    np.testing.assert_array_equal(got.board_found, want.board_found)
    assert got.fens == want.fens
    np.testing.assert_allclose(got.quadrangle, np.asarray(want.quadrangle), atol=1e-3)
