"""Parity of the PyTorch port's models and weight loading with the JAX
package, on the CPU, with the committed weights.

The Flax modules are built with ``dtype=jnp.float32`` and the port's with
float32 convolutions, and both get the same numpy inputs from a seed.
Tolerances: logits atol 2e-3 after ~23 float32 conv layers whose sums
run in another order; probabilities atol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import checkpoint as jcheckpoint
from chessvision_tpu.models.resnet import resnet18 as flax_resnet18
from chessvision_tpu.models.unet import UNet as FlaxUNet
from chessvision_tpu_torch import checkpoint, constants, models
from chessvision_tpu_torch.core import build_model
from chessvision_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d
from chessvision_tpu_torch.weights import flax_to_torch

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def unet_vars() -> dict:
    return jcheckpoint.load_checkpoint(constants.BEST_EXTRACTOR_WEIGHTS)[0]


@pytest.fixture(scope="module")
def resnet_vars() -> dict:
    return jcheckpoint.load_checkpoint(constants.BEST_CLASSIFIER_WEIGHTS)[0]


def test_checkpoint_reader_matches_jax(unet_vars) -> None:
    got, meta = checkpoint.load_checkpoint(constants.BEST_EXTRACTOR_WEIGHTS)
    want_meta = jcheckpoint.load_metadata(constants.BEST_EXTRACTOR_WEIGHTS)
    assert meta == want_meta
    assert meta["training_config"]["base"] == 32 and meta["training_config"]["bilinear"] is False
    flat_got = dict(_flat(got))
    flat_want = dict(_flat(unet_vars))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_got[k].dtype == np.float32  # f16 storage upcast
        np.testing.assert_array_equal(flat_got[k], v)


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_load_variables_drops_opt_state_and_promotes_ema(tmp_path) -> None:
    params = {"fc": {"kernel": np.ones((2, 3), np.float32)}}
    ema = {"fc": {"kernel": np.full((2, 3), 2.0, np.float16)}}
    path = tmp_path / "ck.npz"
    jcheckpoint.save_checkpoint(path, {"params": params, "ema_params": ema}, {"epoch": 3})
    with np.load(path) as data:
        flat = dict(data)
    flat["opt_state/leaf0000"] = np.zeros(3, np.float32)
    np.savez(path, **flat)
    variables, meta = checkpoint.load_variables(path)
    assert set(variables) == {"params"} and meta == {"epoch": 3}
    np.testing.assert_array_equal(variables["params"]["fc"]["kernel"], np.full((2, 3), 2.0, np.float32))


def test_unet_logits_match_flax(unet_vars) -> None:
    x = np.random.default_rng(0).random((2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(FlaxUNet(base=32, bilinear=False, dtype=jnp.float32).apply(unet_vars, jnp.asarray(x)))
    model, spec = build_model("extractor", None, constants.BEST_EXTRACTOR_WEIGHTS, torch.float32, CPU)
    assert spec.model_id == "unet" and spec.input_size == (256, 256) and spec.in_channels == 3
    assert sum(p.numel() for p in model.parameters()) == 7_763_041
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 256, 256, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_resnet_probabilities_match_flax(resnet_vars) -> None:
    x = np.random.default_rng(1).random((4, 64, 64, 1)).astype(np.float32)
    logits = flax_resnet18(dtype=jnp.float32).apply(resnet_vars, jnp.asarray(x))
    want = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
    model, spec = build_model("classifier", None, constants.BEST_CLASSIFIER_WEIGHTS, torch.float32, CPU)
    assert spec.model_id == "resnet18" and spec.input_size == (64, 64) and not spec.outputs_probabilities
    assert sum(p.numel() for p in model.parameters()) == 11_176_909
    with torch.inference_mode():
        got_logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=2e-3)
    np.testing.assert_allclose(torch.softmax(got_logits, -1).numpy(), want, atol=1e-5)


def test_bf16_models_keep_bn_and_head_in_float32(unet_vars) -> None:
    model, _ = build_model("extractor", None, constants.BEST_EXTRACTOR_WEIGHTS, torch.bfloat16, CPU)
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert convs and all(m.weight.dtype == torch.bfloat16 for m in convs)
    assert bns and all(m.weight.dtype == torch.float32 and m.running_var.dtype == torch.float32 for m in bns)
    x = np.random.default_rng(2).random((1, 256, 256, 3)).astype(np.float32)
    f32 = np.asarray(FlaxUNet(base=32, dtype=jnp.float32).apply(unet_vars, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # bf16 operands (8 mantissa bits) through ~23 convs: probabilities stay
    # within a few hundredths of the float32 model's
    np.testing.assert_allclose(torch.sigmoid(got).numpy(), 1 / (1 + np.exp(-f32)), atol=0.1)


def test_flax_to_torch_strict(resnet_vars) -> None:
    model = models.resnet18()
    state = flax_to_torch(resnet_vars, model)
    model.load_state_dict(state)
    conv = resnet_vars["params"]["layer2_0"]["down_conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["layer2_0.down_conv.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["fc.weight"].numpy(), resnet_vars["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(
        state["bn1.running_var"].numpy(), resnet_vars["batch_stats"]["bn1"]["var"]
    )
    extra = {**resnet_vars, "params": {**resnet_vars["params"], "head2": {"kernel": np.zeros((3, 3))}}}
    with pytest.raises(KeyError, match="head2"):
        flax_to_torch(extra, model)
    partial = {**resnet_vars, "params": {k: v for k, v in resnet_vars["params"].items() if k != "fc"}}
    with pytest.raises(KeyError, match="fc.weight"):
        flax_to_torch(partial, model)
    assert "fc.weight" not in flax_to_torch(partial, model, strict=False)


def test_convtranspose_weight_is_inverse_of_jax_converter() -> None:
    """checkpoint._convtranspose_kernel maps torch (in, out, kH, kW) to the
    flipped Flax layout; flax_to_torch undoes it exactly."""
    w = np.random.default_rng(3).random((8, 4, 2, 2)).astype(np.float32)
    flax_kernel = np.ascontiguousarray(jcheckpoint._convtranspose_kernel(w))
    up = ConvTranspose2d(8, 4, 2, stride=2)
    variables = {"params": {"up": {"kernel": flax_kernel, "bias": np.zeros(4, np.float32)}}}
    state = flax_to_torch(variables, torch.nn.ModuleDict({"up": up}))
    np.testing.assert_array_equal(state["up.weight"].numpy(), w)


def test_registry_has_the_ported_models_only() -> None:
    ex, spec = models.create_extractor(None, base=8)
    assert isinstance(ex, models.UNet) and spec.model_id == "unet"
    cl, spec = models.create_classifier(None, width=8)
    assert isinstance(cl, models.ResNet) and spec.model_id == "resnet18"
    assert sorted(models.EXTRACTORS) == ["unet", "yolo", "yolo11_seg"] and sorted(models.CLASSIFIERS) == ["resnet18", "yolo"]
    for create in (models.create_extractor, models.create_classifier):
        with pytest.raises(ValueError, match="unknown model id"):
            create("detr")
    assert isinstance(ex.outc, Conv2d) and ex.outc.bias is not None
