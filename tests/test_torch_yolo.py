"""The port's YOLO model slots against the JAX package, on the CPU.

The Flax modules are built with ``dtype=jnp.float32`` and the port's with
float32 convolutions; both get the same numpy inputs from a seed.
Tolerance: logits and features atol 1e-4 (13 to 16 float32 conv layers
whose sums run in another order; 1e-5 was measured at the committed
weights).  End to end with the yolo ids, ``found`` flags and FENs equal the
JAX facade's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import checkpoint as jcheckpoint
from chessvision_tpu.core import ChessVision as JaxChessVision
from chessvision_tpu.models.yolo import YoloCls as FlaxYoloCls
from chessvision_tpu.models.yolo import YoloSeg as FlaxYoloSeg
from chessvision_tpu_torch import constants, models
from chessvision_tpu_torch.core import ChessVision, build_model
from chessvision_tpu_torch.models.layers import BatchNorm2d
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.weights import flax_to_torch

CPU = torch.device("cpu")
ATOL = 1e-4


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _randomized(variables: dict, seed: int) -> dict:
    """Flax init leaves BatchNorm at scale 1, bias 0, mean 0, var 1; draw
    all four so that a swapped or dropped statistic shows."""
    rng = np.random.default_rng(seed)
    out = _numpy_tree(variables)
    out["batch_stats"] = jax.tree.map(lambda a: a + rng.uniform(0.1, 0.9, a.shape).astype(np.float32), out["batch_stats"])
    out["params"] = jax.tree.map(
        lambda a: a + rng.uniform(-0.3, 0.3, a.shape).astype(np.float32) if a.ndim == 1 else a, out["params"]
    )
    return out


def _load(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    model.load_state_dict(flax_to_torch(variables, model))
    return model.eval()


def test_yolocls_width8_matches_flax_with_features() -> None:
    x = np.random.default_rng(0).random((3, 64, 64, 1)).astype(np.float32)
    flax = FlaxYoloCls(width=8, dtype=jnp.float32)
    variables = _randomized(jax.jit(flax.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    want_logits, want_feats = jax.jit(lambda v, t: flax.apply(v, t, return_features=True))(variables, jnp.asarray(x))
    model, spec = models.create_classifier("yolo", width=8)
    assert isinstance(model, models.YoloCls) and spec.outputs_probabilities and spec.input_size == (64, 64)
    _load(model, variables)
    with torch.inference_mode():
        logits, feats = model(torch.from_numpy(x), return_features=True)
        only_logits = model(torch.from_numpy(x))
    assert logits.shape == (3, 13) and feats.shape == (3, 64) and feats.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=ATOL)
    np.testing.assert_array_equal(only_logits.numpy(), logits.numpy())


def test_yoloseg_width8_matches_flax() -> None:
    x = np.random.default_rng(2).random((2, 64, 96, 3)).astype(np.float32)
    flax = FlaxYoloSeg(width=8, dtype=jnp.float32)
    variables = _randomized(jax.jit(flax.init)(jax.random.PRNGKey(3), jnp.asarray(x)), 3)
    want = np.asarray(jax.jit(flax.apply)(variables, jnp.asarray(x)))
    model, spec = models.create_extractor("yolo", width=8)
    assert isinstance(model, models.YoloSeg) and not spec.outputs_probabilities and spec.in_channels == 3
    assert model.head.bias is not None and model.e1.conv.bias is None
    _load(model, variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 64, 96, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize(
    "kind,path,n_params,n_state",
    [
        ("extractor", constants.BEST_YOLO_EXTRACTOR, 2_529_345, 72),
        ("classifier", constants.BEST_YOLO_CLASSIFIER, 3_712_749, 67),
    ],
    ids=["extractor", "classifier"],
)
def test_committed_yolo_weights_match_flax(kind, path, n_params, n_state) -> None:
    variables, metadata = jcheckpoint.load_checkpoint(path)
    assert metadata["training_config"]["model_id"] == "yolo"
    shape = (2, 256, 256, 3) if kind == "extractor" else (4, 64, 64, 1)
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    flax = (FlaxYoloSeg if kind == "extractor" else FlaxYoloCls)(width=32, dtype=jnp.float32)
    want = np.asarray(jax.jit(flax.apply)({k: variables[k] for k in ("params", "batch_stats")}, jnp.asarray(x)))
    model, spec = build_model(kind, "yolo", path, torch.float32, CPU)
    assert spec.model_id == "yolo"
    assert sum(p.numel() for p in model.parameters()) == n_params
    # every array of the checkpoint lands in the state dict (strict), which
    # beside them holds only BatchNorm's batch counters
    state = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert len(state) == n_state == len(jax.tree.leaves({k: variables[k] for k in ("params", "batch_stats")}))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flax_to_torch_strict_on_yolo_checkpoints() -> None:
    variables, _ = jcheckpoint.load_checkpoint(constants.BEST_YOLO_CLASSIFIER)
    model = models.YoloCls(width=32)
    state = flax_to_torch(variables, model, strict=True)
    model.load_state_dict(state, strict=True)
    p = variables["params"]
    np.testing.assert_array_equal(state["block1.cv2.conv.weight"].numpy(), p["block1"]["cv2"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["head.weight"].numpy(), p["head"]["kernel"].T)
    assert tuple(state["head.weight"].shape) == (13, 256)
    np.testing.assert_array_equal(state["stem.bn.running_var"].numpy(), variables["batch_stats"]["stem"]["bn"]["var"])
    with pytest.raises(ValueError, match="shape"):
        flax_to_torch(variables, models.YoloCls(width=16))
    seg_vars, _ = jcheckpoint.load_checkpoint(constants.BEST_YOLO_EXTRACTOR)
    with pytest.raises(KeyError):  # a segmenter's tree does not fit the classifier
        flax_to_torch(seg_vars, model)
    seg = models.YoloSeg(width=32)
    seg.load_state_dict(flax_to_torch(seg_vars, seg, strict=True), strict=True)


def test_yolo_layer_contract() -> None:
    """BatchNorm eps 1e-3 in float32 under bfloat16 convolutions; the
    classifier head stays float32; the residual is added only where the
    channels match."""
    model, _ = build_model("classifier", "yolo", constants.BEST_YOLO_CLASSIFIER, torch.bfloat16, CPU)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(bns) == len(convs) == 13
    assert all(m.eps == 1e-3 and m.weight.dtype == torch.float32 for m in bns)
    assert all(m.weight.dtype == torch.bfloat16 for m in convs)
    assert model.head.weight.dtype == torch.float32
    with torch.inference_mode():
        out = model(torch.rand(2, 64, 64, 1))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert models.yolo.Bottleneck(8, 8).residual and not models.yolo.Bottleneck(8, 16).residual
    assert models.resnet18().bn1.eps == 1e-5  # the other families keep theirs


def test_facade_picks_yolo_default_weights(tmp_path) -> None:
    cv = ChessVision(board_extractor_model_id="yolo", classifier_model_id="yolo", device="cpu")
    assert cv._board_extractor_weights == constants.BEST_YOLO_EXTRACTOR
    assert cv._classifier_weights == constants.BEST_YOLO_CLASSIFIER
    default = ChessVision(device="cpu")
    assert default._board_extractor_weights == constants.BEST_EXTRACTOR_WEIGHTS
    assert default._classifier_weights == constants.BEST_CLASSIFIER_WEIGHTS
    mixed = ChessVision(classifier_model_id="yolo", classifier_weights=str(tmp_path / "mine.npz"), device="cpu")
    assert mixed._classifier_weights == str(tmp_path / "mine.npz")  # explicit weights win
    assert mixed._board_extractor_weights == constants.BEST_EXTRACTOR_WEIGHTS
    assert constants.BEST_YOLO_EXTRACTOR.endswith("weights/best_yolo_extractor.npz")
    ex, spec = cv.board_extractor
    assert isinstance(ex, models.YoloSeg) and ex.e1.conv.out_channels == 32  # width from training_config
    cl, spec = cv.classifier
    assert isinstance(cl, models.YoloCls) and spec.outputs_probabilities


def test_end_to_end_yolo_matches_jax_facade() -> None:
    frames = board_frames(seed=21, n=2)[0]
    ref = JaxChessVision(
        board_extractor_model_id="yolo", classifier_model_id="yolo", dtype=jnp.float32, refine_grid="arbitrate"
    )
    want = ref.engine.process_batch(frames)
    port = ChessVision(board_extractor_model_id="yolo", classifier_model_id="yolo", dtype=torch.float32, device="cpu")
    got = port.engine.process_batch(frames)
    assert np.asarray(want.board_found).any()
    np.testing.assert_array_equal(got.board_found, np.asarray(want.board_found))
    assert got.fens == want.fens and got.original_fens == want.original_fens
    np.testing.assert_allclose(got.quadrangle, want.quadrangle, atol=1e-3)
    np.testing.assert_allclose(got.logits, want.logits, atol=2e-3)
    # the classifier's raw outputs pass for probabilities (the registry's
    # flag), so they are logits-sized: same tolerance as the arbitrate blend
    # of the UNet/ResNet pair, scaled to their range
    np.testing.assert_allclose(got.probabilities, want.probabilities, atol=1e-3 * max(1.0, np.abs(want.probabilities).max()))
