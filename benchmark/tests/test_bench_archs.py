"""Reference models found by name: each configuration's model ids resolve
to ``reference/archs/<model_id>.py``, grouped convolutions go through
``Layers.conv`` (and so through the float8 control), and an architecture
dropped into a folder of its own runs through the seeded weights, the
reference and the ``bn_act`` byte count with no other file touched."""

import hashlib
import json
import shutil

import pytest
import torch
import torch.nn.functional as F

from benchmark.counts import bn_bytes
from benchmark.harness import frames, spec, weights
from benchmark.reference import models, ops, pipeline

torch.set_num_threads(4)
CPU = torch.device("cpu")
_BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())

# A segmenter of two convolutions, the second depthwise, then BatchNorm,
# SiLU and a 1×1 head: what a new architecture file looks like.
TOY = '''
import torch.nn.functional as F

from benchmark.reference.models import bn_leaves


def forward(L, x):
    x = L.conv(x.permute(0, 3, 1, 2), "stem", padding=1)
    x = L.conv(x, "dw", padding=1, groups=x.shape[1])
    return L.conv(F.silu(L.bn(x, "bn", 1e-3)), "head")[:, 0]


def leaves(width=8):
    return {"params/stem/kernel": (3, 3, 3, width), "params/dw/kernel": (3, 3, 1, width),
            **bn_leaves("bn", width), "params/head/kernel": (1, 1, width, 1), "params/head/bias": (1,)}
'''
TOY_BN_ACT = TOY + '''

def bn_out_item(path, act):
    return 4, 0
'''


@pytest.mark.parametrize("config_name", [c["name"] for c in _BENCH["configs"]])
def test_every_model_id_resolves(config_name):
    file = next(c["file"] for c in _BENCH["configs"] if c["name"] == config_name)
    cfg = json.loads((spec.ROOT / file).read_text())
    for model in cfg["models"].values():
        arch = models.arch(model["model_id"])
        assert arch is models.arch(model["model_id"])
        assert callable(arch.forward) and arch.leaves(**model["arch"])


def test_an_unknown_id_names_the_folder_and_its_ids():
    with pytest.raises(KeyError) as err:
        models.arch("yolo11")
    msg = str(err.value)
    assert str(models.ARCHS) in msg and "'resnet18'" in msg and "'unet'" in msg


@pytest.mark.parametrize("groups", [16, 2])
def test_grouped_convolutions_pass_through_the_layers(groups):
    g = torch.Generator().manual_seed(2**31 + 11)
    x = torch.randn((2, 16, 20, 20), generator=g)
    w = torch.randn((16, 16 // groups, 3, 3), generator=g)  # torch's layout
    b = torch.randn((16,), generator=g)
    flat = {"params/c/kernel": w.permute(2, 3, 1, 0).contiguous().numpy(), "params/c/bias": b.numpy()}
    plain = models.Layers(flat, CPU).conv(x, "c", padding=1, groups=groups)
    assert torch.equal(plain, F.conv2d(x, w, b, padding=1, groups=groups))
    low = models.Layers(flat, CPU, precision="fp8").conv(x, "c", stride=2, padding=1, groups=groups)
    assert torch.equal(low, F.conv2d(models._fp8(x), models._fp8(w), b, 2, 1, groups=groups))
    assert not torch.equal(low, F.conv2d(x, w, b, 2, 1, groups=groups))


def _snapshot():
    files = [spec.ROOT / "BENCHMARK.json"] + sorted(
        p for p in spec.HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts)
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def _toy_config(model_id, width):
    cfg = spec.load_cell("unet64.batch512").config
    cfg["dtype"] = "float32"
    cfg["models"]["extractor"].update(model_id=model_id, arch={"width": width}, weights="seeded", held={})
    return cfg


def test_a_new_architecture_is_one_new_file(tmp_path, monkeypatch):
    before = _snapshot()
    (tmp_path / "toyseg.py").write_text(TOY_BN_ACT)
    (tmp_path / "toyplain.py").write_text(TOY)
    shutil.copy(models.ARCHS / "resnet18.py", tmp_path / "resnet18.py")
    monkeypatch.setattr(models, "ARCHS", tmp_path)

    cfg = _toy_config("toyseg", 8)
    seeded = weights.make(cfg, 2**31 + 3, CPU)
    leaves = seeded["extractor"]
    assert {k: v.shape for k, v in leaves.items()} == models.arch("toyseg").leaves(width=8)
    ref = pipeline.Reference(cfg, spec.ROOT, CPU, seeded=seeded)
    scene = torch.stack(frames.scenes(2**31 + 7, [(512, 512)], 256, CPU))
    logits = ref.segment(scene)

    t = {k: torch.from_numpy(v) for k, v in leaves.items()}
    x = (ops.round_u8(ops.resize_area(scene)).float() / 255.0).permute(0, 3, 1, 2)
    x = F.conv2d(x, t["params/stem/kernel"].permute(3, 2, 0, 1), padding=1)
    x = F.conv2d(x, t["params/dw/kernel"].permute(3, 2, 0, 1), padding=1, groups=8)
    mul = torch.rsqrt(t["batch_stats/bn/var"] + 1e-3) * t["params/bn/scale"]
    x = F.silu((x - t["batch_stats/bn/mean"][:, None, None]) * mul[:, None, None] + t["params/bn/bias"][:, None, None])
    want = F.conv2d(x, t["params/head/kernel"].permute(3, 2, 0, 1), t["params/head/bias"])[:, 0]
    assert logits.shape == (1, 256, 256)
    torch.testing.assert_close(logits, want)

    # one BatchNorm of 256² × width elements: bf16 in, float32 out as its
    # bn_out_item says, three float32 channel vectors; the classifier's
    # bytes are the same at both widths
    narrow = pipeline.Reference(_toy_config("toyseg", 4), spec.ROOT, CPU,
                                seeded=weights.make(_toy_config("toyseg", 4), 2**31 + 3, CPU))
    wide_bytes = bn_bytes.bn_act_bytes_per_board(ref, "bfloat16")
    assert wide_bytes - bn_bytes.bn_act_bytes_per_board(narrow, "bfloat16") == 4 * (256 * 256 * (2 + 4) + 3 * 4)

    plain = pipeline.Reference(_toy_config("toyplain", 4), spec.ROOT, CPU,
                               seeded=weights.make(_toy_config("toyplain", 4), 2**31 + 3, CPU))
    with pytest.raises(ValueError, match="toyplain runs no bn_act"):
        bn_bytes.bn_act_bytes_per_board(plain, "bfloat16")
    assert _snapshot() == before
