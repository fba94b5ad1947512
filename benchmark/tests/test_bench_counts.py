"""The benchmark's counts of work against the port's own arithmetic."""

import json

import numpy as np
import pytest
import torch

from benchmark.counts import bn_bytes, flops, k1_bytes, peaks
from benchmark.harness import loop, spec, weights
from benchmark.reference import models, ops, pipeline

torch.set_num_threads(4)

_BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
# the first cell of each configuration of BENCHMARK.json
FIRST_CELLS = [next(w["name"] for w in _BENCH["workloads"] if w["config"] == c["name"]) for c in _BENCH["configs"]]


def _runs_bn_act(cell):
    """Whether every model of the cell's configuration runs ``bn_act``
    (its architecture file defines ``bn_out_item``)."""
    return all(hasattr(models.arch(m["model_id"]), "bn_out_item") for m in spec.load_cell(cell).config["models"].values())


def _config(cell):
    cfg = spec.load_cell(cell).config
    cfg["dtype"] = "float32"
    return cfg, weights.make(cfg, 1, torch.device("cpu"))


def _reference(cell):
    cfg, seeded = _config(cell)
    return pipeline.Reference(cfg, spec.ROOT, torch.device("cpu"), seeded=seeded)


def _port_engine(cell):
    cfg, seeded = _config(cell)
    return loop.build(cfg, spec.ROOT, torch.device("cpu"), seeded).engine


@pytest.mark.parametrize("cell", FIRST_CELLS)
def test_flops_equal_the_ports_count(cell):
    from chessvision_tpu_torch.tools.flops import pipeline_flops_per_board

    mine = flops.pipeline_flops_per_board(_reference(cell), 512, 512)
    theirs = pipeline_flops_per_board(_port_engine(cell), np.zeros((1, 512, 512, 3), np.uint8), n=2)
    assert mine == theirs
    assert mine > 1e9


def test_photo_flops_add_the_resize_matmuls():
    ref = _reference("unet32.photo12mp")
    small = flops.pipeline_flops_per_board(ref, 512, 512, n=1)
    photo = flops.pipeline_flops_per_board(ref, 600, 800, n=1)
    resize = 2 * 256 * 600 * 800 * 3 + 2 * 256 * 800 * 256 * 3
    assert photo == pytest.approx(small + resize, rel=1e-9)


def test_tap_sector_bytes_equal_the_ports():
    from chessvision_tpu_torch.tools.flops import tap_sector_bytes

    g = torch.Generator().manual_seed(2)
    img = torch.empty((2, 300, 400))
    assert img.data_ptr() % 32 == 0
    src = torch.tensor([[[30.0, 20.0], [370.0, 35.0], [360.0, 280.0], [25.0, 270.0]],
                        [[60.0, 50.0], [300.0, 40.0], [320.0, 250.0], [50.0, 260.0]]])
    src = src + torch.rand(src.shape, generator=g)
    dst = torch.tensor([[32.0, 32.0], [544.0, 32.0], [544.0, 544.0], [32.0, 544.0]]).expand(2, 4, 2)
    ms = ops.perspective_transform(src, dst)
    hx, vy = ops.twopass_positions(ops.invert_homography(ms), 300, 576, 576)
    mine = k1_bytes.tap_sector_bytes((2, 300, 400), hx, vy)
    assert mine == tap_sector_bytes(img, hx, vy)
    per_board = k1_bytes.warp_floor_bytes((300, 400), ms, 576)
    assert per_board == mine + 2 * 576 * 576 * 4
    assert 0 < mine <= 2 * 300 * 400 * 4


@pytest.mark.parametrize("cell", [c for c in FIRST_CELLS if _runs_bn_act(c)])
def test_bn_act_bytes_equal_what_the_ports_bn_act_moves(cell, monkeypatch):
    """Each ``bn_act`` call of the port's bfloat16 models, on the CPU where
    it runs its plain version: its input, residual and output bytes as the
    tensors it is given and returns, and its three channel vectors."""
    from chessvision_tpu_torch.models import layers

    moved = [0.0]
    real = layers.bn_act

    def counting(x, mean, mul, bias, residual, relu, out_dtype):
        y = real(x, mean, mul, bias, residual, relu, out_dtype)
        moved[0] += x.numel() * x.element_size() + y.numel() * y.element_size() + 3 * 4 * x.shape[1]
        if residual is not None:
            moved[0] += residual.numel() * residual.element_size()
        return y

    monkeypatch.setattr(layers, "bn_act", counting)
    cfg = spec.load_cell(cell).config
    cfg["dtype"] = "bfloat16"
    cv = loop.build(cfg, spec.ROOT, torch.device("cpu"), weights.make(cfg, 1, torch.device("cpu")))
    with torch.inference_mode():
        cv.board_extractor[0](torch.zeros((1, 256, 256, 3)))
        for _ in range(2):
            cv.classifier[0](torch.zeros((64, 64, 64, 1)))
    assert bn_bytes.bn_act_bytes_per_board(_reference(cell), "bfloat16") == moved[0]


def test_peaks_are_the_ports_table():
    from chessvision_tpu_torch.tools.card import PEAKS

    assert peaks.PEAKS == PEAKS
    assert peaks.PEAKS["NVIDIA H100 80GB HBM3"] == {"bf16_flop_per_s": 989.4e12, "bytes_per_s": 3.35e12}
