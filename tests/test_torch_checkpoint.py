"""The port's checkpoint writer against the JAX package's, on the CPU.

- save / load / optimizer leaves / strip / promote (float16) / EMA /
  metadata, mirroring tests/test_checkpoint.py;
- ``torch_to_flax(flax_to_torch(x)) == x`` exactly for the UNet, the
  ResNet and both YOLO models (random and committed weights);
- a port-written training checkpoint loads in the JAX ``load_checkpoint``
  and its optimizer leaves are jax.tree.leaves of the JAX trainers' own
  optimizer state in count, order, shape and dtype (UNet: the injected
  RMSprop chain; ResNet: Adam with the step schedule), and the reverse:
  the port restores a JAX-written one exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chessvision_tpu import checkpoint as jckpt
from chessvision_tpu import models as jmodels
from chessvision_tpu_torch import checkpoint as tckpt
from chessvision_tpu_torch import models as tmodels
from chessvision_tpu_torch import weights
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.train import steps as tsteps

REPO_WEIGHTS = {
    "unet": ("weights/best_extractor.npz", lambda: tmodels.UNet(base=32)),
    "resnet18": ("weights/best_classifier.npz", lambda: tmodels.resnet18()),
    "yolo_seg": ("weights/best_yolo_extractor.npz", lambda: tmodels.YoloSeg()),
    "yolo_cls": ("weights/best_yolo_classifier.npz", lambda: tmodels.YoloCls()),
}


@pytest.fixture
def small(tmp_path):
    """A YoloCls(width=8) state with an Adam optimizer state in the port."""
    torch.manual_seed(0)
    model = tmodels.YoloCls(width=8)
    state = tsteps.TrainState.create(model, tsteps.adam(1e-3))
    tsteps.make_cls_train_step()(state, torch.rand(4, 64, 64, 1), torch.arange(4))
    return model, state, tmp_path


def test_optimizer_state_roundtrip_and_strip(small) -> None:
    model, state, tmp_path = small
    path = tmp_path / "ck.npz"
    tckpt.save_checkpoint(path, tsteps.checkpoint_variables(state), {"epoch": 1}, opt_state=state.opt_state_leaves())
    loaded, meta = tckpt.load_checkpoint(path)
    leaves = tckpt.load_opt_state_leaves(loaded)
    want = state.opt_state_leaves()
    assert leaves is not None and len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a, b)
    stripped = tckpt.strip_checkpoint(path, tmp_path / "stripped.npz")
    loaded2, meta2 = tckpt.load_checkpoint(stripped)
    assert tckpt.load_opt_state_leaves(loaded2) is None and meta2 == meta
    assert stripped.stat().st_size < path.stat().st_size


def test_promote_fp16_roundtrip(small) -> None:
    model, state, tmp_path = small
    src = tmp_path / "train.npz"
    tckpt.save_checkpoint(src, tsteps.checkpoint_variables(state), {"best_val_score": 0.9}, opt_state=state.opt_state_leaves())
    dest = tckpt.promote_checkpoint(src, tmp_path / "best.npz")
    assert dest.stat().st_size < src.stat().st_size
    with np.load(dest) as raw:
        assert all(raw[k].dtype == np.float16 for k in raw.files if k.startswith("params/"))
        assert all(raw[k].dtype == np.float32 for k in raw.files if k.startswith("batch_stats/"))
    loaded, meta = tckpt.load_checkpoint(dest)
    assert meta["best_val_score"] == 0.9 and tckpt.load_opt_state_leaves(loaded) is None
    ref = weights.torch_to_flax(model)["params"]
    for a, b in zip(jax.tree.leaves(loaded["params"]), jax.tree.leaves(ref)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    # the JAX package promotes the same file to the same bytes
    jdest = jckpt.promote_checkpoint(src, tmp_path / "best_jax.npz")
    with np.load(dest) as a, np.load(jdest) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)
    twin = tmodels.YoloCls(width=8)
    twin.load_state_dict(weights.flax_to_torch(loaded, twin))
    assert twin.eval()(torch.zeros(1, 64, 64, 1)).shape == (1, 13)


def test_ema_checkpoint_keeps_raw_params_and_promotes_ema(small) -> None:
    model, state, tmp_path = small
    ema = [p.detach() + 1.0 for p in state.params]
    src = tmp_path / "train_ema.npz"
    tckpt.save_checkpoint(src, tsteps.checkpoint_variables(state, ema), {"epoch": 3}, opt_state=state.opt_state_leaves())
    loaded, _ = tckpt.load_checkpoint(src)
    assert tckpt.load_opt_state_leaves(loaded) is not None
    for a, b in zip(tsteps.params_from_tree(state, loaded["ema_params"]), ema):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    promoted, _ = tckpt.load_checkpoint(tckpt.promote_checkpoint(src, tmp_path / "best_ema.npz", compress=False))
    assert "ema_params" not in promoted and "opt_state" not in promoted
    for a, b in zip(jax.tree.leaves(promoted["params"]), jax.tree.leaves(loaded["ema_params"])):
        np.testing.assert_array_equal(a, b)


def test_metadata_driven_model_reconstruction(tmp_path) -> None:
    torch.manual_seed(0)
    path = tmp_path / "ext.npz"
    tckpt.save_checkpoint(path, weights.torch_to_flax(tmodels.UNet(base=16)),
                          {"training_config": {"model_id": "unet", "base": 16, "bilinear": False}})
    cv = ChessVision(board_extractor_weights=str(path), device="cpu", dtype=torch.float32)
    module, _ = cv.board_extractor
    assert module.inc.conv1.out_channels == 16
    assert module(torch.zeros(1, 64, 64, 3)).shape == (1, 64, 64, 1)
    assert tckpt.load_metadata(path)["training_config"]["base"] == 16
    assert jckpt.load_metadata(path) == tckpt.load_metadata(path)


@pytest.mark.parametrize("name", sorted(REPO_WEIGHTS))
def test_torch_to_flax_inverts_flax_to_torch(name) -> None:
    path, build = REPO_WEIGHTS[name]
    variables, _ = tckpt.load_checkpoint(path)
    model = build()
    model.load_state_dict(weights.flax_to_torch(variables, model))
    back = weights._flatten(weights.torch_to_flax(model))
    want = weights._flatten({k: variables[k] for k in ("params", "batch_stats")})
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape and back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k].astype(np.float32))
    # and from random weights, in the other direction
    torch.manual_seed(1)
    fresh = build()
    twin = build()
    twin.load_state_dict(weights.flax_to_torch(weights.torch_to_flax(fresh), twin))
    for (k, a), b in zip(fresh.state_dict().items(), twin.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def _jax_trainer_opt_state(kind: str, params):
    """The optimizer state the JAX trainers build (train_unet.py:175-186,
    train_classifier.py:151-167)."""
    if kind == "unet":
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.add_decayed_weights(1e-8),
                         optax.inject_hyperparams(optax.rmsprop)(learning_rate=3e-5, momentum=0.999, eps=1e-8))
    else:
        tx = optax.adam(optax.exponential_decay(1e-3, transition_steps=8, decay_rate=0.1, staircase=True))
    return tx, tx.init(params)


def _port_trainer_tx(kind: str) -> tsteps.Transform:
    if kind == "unet":
        return tsteps.Chain([tsteps.ClipByGlobalNorm(1.0), tsteps.AddDecayedWeights(1e-8),
                             tsteps.inject_hyperparams(tsteps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
    return tsteps.adam(tsteps.exponential_decay(1e-3, transition_steps=8, decay_rate=0.1, staircase=True))


@pytest.mark.parametrize("kind", ["unet", "resnet18"])
def test_checkpoints_swap_between_the_packages(kind, tmp_path) -> None:
    torch.manual_seed(0)
    if kind == "unet":
        model, jmodel, x = tmodels.UNet(base=4), jmodels.UNet(base=4, dtype=jnp.float32), torch.rand(2, 64, 64, 3)
        step = tsteps.make_seg_train_step()
        batch = (x, (torch.rand(2, 64, 64) > 0.5).float())
    else:
        model, jmodel, x = tmodels.resnet18(width=8), jmodels.resnet18(width=8, dtype=jnp.float32), torch.rand(8, 64, 64, 1)
        step = tsteps.make_cls_train_step()
        batch = (x, torch.arange(8) % 13)
    state = tsteps.TrainState.create(model, _port_trainer_tx(kind))
    step(state, *batch)  # a state worth saving: counts 1, moments nonzero
    path = tmp_path / "port.npz"
    tckpt.save_checkpoint(path, tsteps.checkpoint_variables(state), {"epoch": 1}, opt_state=state.opt_state_leaves())

    # the port's file in the JAX loader: the trainer's own structures
    loaded, meta = jckpt.load_checkpoint(path)
    tx, jstate = _jax_trainer_opt_state(kind, loaded["params"])
    want = jax.tree.leaves(jstate)
    leaves = jckpt.load_opt_state_leaves(loaded)
    assert [(np.shape(a), np.asarray(a).dtype) for a in want] == [(b.shape, b.dtype) for b in leaves]
    rebuilt = jax.tree.unflatten(jax.tree.structure(jstate), [jnp.asarray(v) for v in leaves])
    variables = {"params": loaded["params"], "batch_stats": loaded["batch_stats"]}
    out = jax.jit(jmodel.apply)(variables, jnp.asarray(x.numpy()))
    torch.testing.assert_close(torch.from_numpy(np.asarray(out)), model.eval()(x), atol=1e-4, rtol=1e-4)
    # the JAX optimizer takes the restored state: one more update runs
    grads = jax.tree.map(jnp.ones_like, loaded["params"])
    tx.update(grads, rebuilt, loaded["params"])

    # and the reverse: a JAX-written checkpoint restores the port exactly
    jpath = tmp_path / "jax.npz"
    jckpt.save_checkpoint(jpath, loaded, meta, opt_state=rebuilt)
    twin = tsteps.TrainState.create(tmodels.UNet(base=4) if kind == "unet" else tmodels.resnet18(width=8), _port_trainer_tx(kind))
    tsteps.restore(twin, tckpt.load_checkpoint(jpath)[0])
    for a, b in zip(twin.opt_state, state.opt_state):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(twin.model.state_dict().values(), state.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
