"""The port's import of the reference implementation's ``.pth`` checkpoints
(``checkpoint.load_torch_checkpoint``) against the JAX package's.

Seeded state dicts in the reference layouts (a milesial UNet at base 4,
with and without its transposed-convolution ups; a torchvision ResNet18 at
width 8 on one channel), saved as the reference saves them, go through
both packages: the variable trees are equal array for array, the metadata
equal, and ``weights.flax_to_torch`` carries the port's tree strictly into
the port's models.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chessvision_tpu import checkpoint as jckpt
from chessvision_tpu_torch import checkpoint as tckpt
from chessvision_tpu_torch import models as tmodels
from chessvision_tpu_torch import weights


def _bn(sd: dict, prefix: str, c: int, rng) -> None:
    sd[f"{prefix}.weight"] = rng.normal(1, 0.1, c)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c)
    sd[f"{prefix}.num_batches_tracked"] = np.int64(7)


def _double_conv(sd: dict, prefix: str, cin: int, cout: int, rng, mid: int | None = None) -> None:
    mid = mid or cout
    sd[f"{prefix}.0.weight"] = rng.normal(0, 0.1, (mid, cin, 3, 3))
    _bn(sd, f"{prefix}.1", mid, rng)
    sd[f"{prefix}.3.weight"] = rng.normal(0, 0.1, (cout, mid, 3, 3))
    _bn(sd, f"{prefix}.4", cout, rng)


def reference_unet_state(base: int, bilinear: bool, seed: int = 0) -> dict[str, torch.Tensor]:
    """A milesial ``UNet(n_channels=3, n_classes=1)`` state dict at width
    ``base`` with seeded values."""
    rng = np.random.default_rng(seed)
    sd: dict = {}
    f = 2 if bilinear else 1
    ch = [base, base * 2, base * 4, base * 8, base * 16 // f]
    _double_conv(sd, "inc.double_conv", 3, ch[0], rng)
    for k in range(1, 5):
        _double_conv(sd, f"down{k}.maxpool_conv.1.double_conv", ch[k - 1], ch[k], rng)
    for k in range(1, 5):
        cin = base * 2 ** (5 - k)  # channels of the concatenation
        cout = base * 2 ** (4 - k) // (f if k < 4 else 1)
        if bilinear:
            _double_conv(sd, f"up{k}.conv.double_conv", cin, cout, rng, mid=cin // 2)
        else:
            sd[f"up{k}.up.weight"] = rng.normal(0, 0.1, (cin, cin // 2, 2, 2))
            sd[f"up{k}.up.bias"] = rng.normal(0, 0.1, cin // 2)
            _double_conv(sd, f"up{k}.conv.double_conv", cin, cout, rng)
    sd["outc.conv.weight"] = rng.normal(0, 0.1, (1, base, 1, 1))
    sd["outc.conv.bias"] = rng.normal(0, 0.1, 1)
    return {k: torch.from_numpy(np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f" else np.int64)) for k, v in sd.items()}


def reference_resnet_state(width: int, seed: int = 1) -> dict[str, torch.Tensor]:
    """A torchvision ``resnet18`` state dict on one input channel at width
    ``width`` with 13 classes, seeded."""
    rng = np.random.default_rng(seed)
    sd: dict = {"conv1.weight": rng.normal(0, 0.1, (width, 1, 7, 7))}
    _bn(sd, "bn1", width, rng)
    cin = width
    for i in range(1, 5):
        c = width * 2 ** (i - 1)
        for j in range(2):
            p = f"layer{i}.{j}"
            sd[f"{p}.conv1.weight"] = rng.normal(0, 0.1, (c, cin if j == 0 else c, 3, 3))
            _bn(sd, f"{p}.bn1", c, rng)
            sd[f"{p}.conv2.weight"] = rng.normal(0, 0.1, (c, c, 3, 3))
            _bn(sd, f"{p}.bn2", c, rng)
            if j == 0 and i > 1:
                sd[f"{p}.downsample.0.weight"] = rng.normal(0, 0.1, (c, cin, 1, 1))
                _bn(sd, f"{p}.downsample.1", c, rng)
        cin = c
    sd["fc.weight"] = rng.normal(0, 0.1, (13, cin))
    sd["fc.bias"] = rng.normal(0, 0.1, 13)
    return {k: torch.from_numpy(np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f" else np.int64)) for k, v in sd.items()}


def _assert_trees_equal(got: dict, want: dict) -> None:
    g, w = weights._flatten(got), weights._flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        assert np.asarray(g[k]).shape == np.asarray(w[k]).shape and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("kind,bilinear", [("unet", False), ("unet", True), ("resnet", False)])
def test_pth_import_matches_jax(tmp_path, kind, bilinear) -> None:
    sd = reference_unet_state(4, bilinear) if kind == "unet" else reference_resnet_state(8)
    path = tmp_path / "best.pth"
    meta = {"epoch": 3, "note": "reference", "not_json": object()}
    torch.save({"model_state_dict": sd, "metadata": meta}, path)
    got, gmeta = tckpt.load_checkpoint(path)
    want, wmeta = jckpt.load_checkpoint(path)
    _assert_trees_equal(got, want)
    assert gmeta == wmeta == {"epoch": 3, "note": "reference"}
    assert tckpt.load_metadata(path) == gmeta
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    convert = tckpt.convert_unet_state_dict if kind == "unet" else tckpt.convert_resnet_state_dict
    jconvert = jckpt.convert_unet_state_dict if kind == "unet" else jckpt.convert_resnet_state_dict
    _assert_trees_equal(convert(numpy_sd), jconvert(numpy_sd))
    model = tmodels.UNet(base=4, bilinear=bilinear) if kind == "unet" else tmodels.resnet18(width=8)
    model.load_state_dict(weights.flax_to_torch(got, model))  # strict: every key and shape


def test_pth_plain_state_dict_and_unknown_layout(tmp_path) -> None:
    path = tmp_path / "plain.pt"
    torch.save(reference_resnet_state(8), path)
    got, meta = tckpt.load_checkpoint(path)
    _assert_trees_equal(got, jckpt.load_checkpoint(path)[0])
    assert meta == {}
    torch.save({"w": torch.zeros(2)}, tmp_path / "odd.pth")
    with pytest.raises(ValueError, match="Unrecognized"):
        tckpt.load_checkpoint(tmp_path / "odd.pth")
