"""The reference pipeline against the port's CPU path, on the committed
weights at B ≤ 2 (float32 on the CPU, where the port runs its plain
versions)."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import frames, loop, spec, weights
from benchmark.reference import models, ops, pipeline

torch.set_num_threads(4)

_BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
# each configuration of BENCHMARK.json with the first of its cells
FIRST_CELL = {c["name"]: next(w["name"] for w in _BENCH["workloads"] if w["config"] == c["name"])
              for c in _BENCH["configs"]}


@pytest.fixture(scope="module")
def scenes():
    return torch.stack(frames.scenes(2**31 + 7, [(512, 512)] * 2, 256, torch.device("cpu")))


def _port(config_name, seed=3):
    """(config, the port's facade, the reference), both holding the
    configuration's weights: its checkpoints, or the leaves seeded from
    ``seed``; float32 on the CPU."""
    cfg = spec.load_cell(FIRST_CELL[config_name]).config
    cfg["dtype"] = "float32"
    cpu = torch.device("cpu")
    seeded = weights.make(cfg, seed, cpu)
    return cfg, loop.build(cfg, spec.ROOT, cpu, seeded), pipeline.Reference(cfg, spec.ROOT, cpu, seeded=seeded)


@pytest.mark.parametrize("config_name", list(FIRST_CELL))
def test_models_match_the_port(config_name):
    cfg, cv, ref = _port(config_name)
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 256, 256, 3), generator=g)
    sq = torch.rand((4, 64, 64, 1), generator=g)
    with torch.inference_mode():
        ex, _ = cv.board_extractor
        cl, _ = cv.classifier
        np.testing.assert_allclose(ref.ex_fn(ref.ex, x).numpy(), ex(x)[..., 0].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ref.cl_fn(ref.cl, sq).numpy(), cl(sq).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config_name", list(FIRST_CELL))
def test_pipeline_matches_the_port(scenes, config_name):
    cfg, cv, ref = _port(config_name)
    out = cv.engine.process_batch(scenes.numpy())
    mine = {k: v.numpy() for k, v in ref.run(scenes).items()}
    np.testing.assert_allclose(mine["logits"], out.logits, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(mine["found"], out.board_found)
    np.testing.assert_array_equal(mine["quadrangle"], out.quadrangle)
    np.testing.assert_array_equal(mine["board_image"], out.board_image)
    np.testing.assert_allclose(mine["probabilities"], out.probabilities, rtol=1e-5, atol=1e-6)
    assert pipeline.fens(mine["probabilities"], mine["found"]) == list(out.fens)


def test_quadrangles_match_the_port():
    from chessvision_tpu_torch.ops.quad import find_quadrangle_batch

    g = torch.Generator().manual_seed(5)
    probs = torch.zeros((3, 256, 256))
    probs[0, 40:200, 50:220] = 0.9
    probs[1, 10:250, 10:250] = 0.8
    probs[1, 100:120, 100:120] = 0.1
    probs[2] = torch.rand((256, 256), generator=g)
    mine, found = ops.find_quadrangles(probs, 0.5)
    theirs, found_t = find_quadrangle_batch(probs, 0.5)
    assert torch.equal(mine, theirs) and torch.equal(found, found_t)


def test_warps_match_the_port_and_each_other():
    from chessvision_tpu_torch.ops.hat_resample import warp_twopass_plain
    from chessvision_tpu_torch.ops.warp import get_perspective_transform, invert_homography

    g = torch.Generator().manual_seed(9)
    img = torch.rand((2, 300, 400), generator=g) * 255
    src = torch.tensor([[[30.0, 20.0], [370.0, 35.0], [360.0, 280.0], [25.0, 270.0]],
                        [[60.0, 50.0], [300.0, 40.0], [320.0, 250.0], [50.0, 260.0]]])
    dst = torch.tensor([[32.0, 32.0], [544.0, 32.0], [544.0, 544.0], [32.0, 544.0]]).expand(2, 4, 2)
    ms = ops.perspective_transform(src, dst)
    assert torch.equal(ms, get_perspective_transform(src, dst))
    minv = ops.invert_homography(ms)
    assert torch.equal(minv, invert_homography(ms))
    two = ops.warp_twopass(img, minv, 96, 96)
    assert torch.equal(two, warp_twopass_plain(img, minv, 96, 96))
    assert torch.equal(ops.warp_fused(img, minv, 96, 96), two)


def test_gridfix_matches_the_port(scenes):
    from chessvision_tpu_torch.ops import gridfix

    wide = torch.nn.functional.pad(ops.bgr_to_gray_u8(scenes).float(), (32, 32, 32, 32))
    board = torch.clamp(torch.floor(wide[:, 32:544, 32:544] + 0.5), 0, 255)
    corr = ops.detect_grid(board)
    assert torch.equal(corr, gridfix.detect_grid(board))
    assert torch.equal(ops.apply_correction(wide, corr, 32), gridfix.apply_correction(wide, corr, margin=32))
    ms = torch.eye(3).expand(2, 3, 3).contiguous()
    assert torch.equal(ops.refined_quadrangle(ms, corr), gridfix.refined_quadrangle(ms, corr))


def test_front_half_matches_the_port():
    from chessvision_tpu_torch.ops.color import bgr_to_gray
    from chessvision_tpu_torch.ops.resize import resize

    g = torch.Generator().manual_seed(11)
    img = torch.randint(0, 256, (1, 600, 800, 3), generator=g, dtype=torch.uint8)
    assert torch.equal(ops.bgr_to_gray_u8(img), bgr_to_gray(img, exact_u8=True))
    assert torch.equal(ops.round_u8(ops.resize_area(img)), resize(img, (256, 256), round_uint8=True))
    box = torch.randint(0, 256, (2, 512, 512, 3), generator=g, dtype=torch.uint8)
    assert torch.equal(ops.round_u8(ops.resize_area(box)), resize(box, (256, 256), round_uint8=True))


@pytest.mark.parametrize("flip", [False, True])
def test_validation_and_fens_match_the_port(flip):
    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch.engine import _fen_strings, validate_labels_batch

    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (64, 64, 13)).astype(np.float32)
    logits[:, :, [1, 7]] += rng.normal(0, 3, (64, 64, 2)).astype(np.float32)  # many kings, some missing
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    found = rng.random(64) < 0.8
    names = constants.SQUARE_NAMES_FLIPPED if flip else constants.SQUARE_NAMES_NORMAL
    assert (pipeline.SQUARES_FLIPPED if flip else pipeline.SQUARES_NORMAL) == names
    validated, _ = validate_labels_batch(probs, names)
    assert pipeline.fens(probs, found, flip) == _fen_strings(probs, validated, found, names)[0]


def test_npz_loader_reads_every_leaf():
    from chessvision_tpu_torch.checkpoint import load_variables

    flat, meta = models.load_npz(spec.ROOT / "weights" / "best_extractor.npz")
    tree, meta_t = load_variables(spec.ROOT / "weights" / "best_extractor.npz")
    assert meta == meta_t
    n = 0
    for key, value in flat.items():
        node = tree
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(value, node)
        n += 1
    assert n > 50


@pytest.mark.parametrize("path, leaves", [("best_extractor.npz", models.arch("unet").leaves(32)),
                                          ("best_classifier.npz", models.arch("resnet18").leaves(64))])
def test_leaf_shapes_are_the_checkpoints(path, leaves):
    flat, _ = models.load_npz(spec.ROOT / "weights" / path)
    assert {k: v.shape for k, v in flat.items()} == leaves


def test_seeded_weights_follow_the_seed():
    cfg = spec.load_cell("unet64.batch512").config
    cpu = torch.device("cpu")
    a, b, c = (weights.make(cfg, s, cpu) for s in (2**31 + 1, 2**31 + 1, 2**31 + 2))
    assert set(a) == {"extractor"} and set(a["extractor"]) == set(models.arch("unet").leaves(64))
    k = "params/down4/conv/conv2/kernel"
    assert np.array_equal(a["extractor"][k], b["extractor"][k]) and not np.array_equal(a["extractor"][k], c["extractor"][k])
    served = torch.from_numpy(a["extractor"][k]).to(torch.bfloat16).float().numpy()
    assert np.array_equal(served, a["extractor"][k])  # a convolution's kernel, in the dtype it is served in
    assert np.std(a["extractor"][k]) == pytest.approx(np.sqrt(2 / (9 * 1024)), rel=0.02)
    assert np.all(a["extractor"]["params/outc/bias"] == 4.0)  # held by the configuration
