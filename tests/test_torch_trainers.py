"""The port's UNet trainer end to end against the JAX package's, on the CPU.

Both packages run ``train_model`` from the same JAX-written checkpoint
(UNet base 4, epoch 0) on the same 64² boards (16 train, 4 val), float32,
no augmentation, no mesh; the port with ``device="cpu"``.  The batch order
is the same by construction (the same ``np.random.Generator`` calls).

Bounds, each with the figure measured when it was set:
- logged losses, val dice, learning rates and guard errors: 1e-5 relative
  (measured 3.1e-6);
- final parameters: the largest difference over the tree relative to the
  largest parameter, 1e-3 (measured 1.5e-4); batch statistics, per leaf,
  2e-3 (measured 2.9e-4); optimizer state over the tree 0.25 (measured
  0.17, on the momentum trace).  RMSprop divides each gradient by its own
  running magnitude, so an element whose gradient is at its rounding level
  (the BatchNorm biases and the ConvTranspose biases that the next
  BatchNorm cancels) takes a step of up to 3·lr in a direction set by
  rounding, and the 0.999 trace keeps it; the losses are unmoved by those
  elements.  tests/test_torch_train_steps.py holds a single step tighter.
- per-sample metrics tables: continuous columns 1e-4, the thresholded IoU
  and pixel accuracy 1e-2, the PCA embedding 1e-2 (measured 2.2e-3: the
  components of a 64-wide bottleneck over 16 samples) after each component's
  sign is aligned.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.train import data as jdata
from chessvision_tpu.train import train_unet as jtrain
from chessvision_tpu_torch.train import data as tdata
from chessvision_tpu_torch.train import train_unet as ttrain
from tests._trainer_parity import (
    checkpoint_errors,
    flat_checkpoint,
    metrics_table_errors,
    scalar_errors,
    seg_data,
    unet_init_checkpoint,
)

COMMON = dict(batch_size=4, augment=False, use_mesh=False, collection_frequency=99, learning_rate=3e-5, seed=5)


@pytest.fixture
def setup(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    monkeypatch.setattr(jdata, "load_board_extraction", lambda *a, **k: seg_data(jdata))
    monkeypatch.setattr(tdata, "load_board_extraction", lambda *a, **k: seg_data(tdata))
    return unet_init_checkpoint(tmp_path / "init.npz")


def _jax(name, **kw):
    return jtrain.train_model(model_dtype=jnp.float32, run_name=name, **{**COMMON, **kw})


def _port(name, **kw):
    return ttrain.train_model(model_dtype=torch.float32, device="cpu", run_name=name, **{**COMMON, **kw})


def _assert_close_runs(run_a, ck_a, run_b, ck_b) -> None:
    assert scalar_errors(run_a, run_b) <= 1e-5
    errs = checkpoint_errors(ck_a, ck_b)
    assert errs["params"] <= 1e-3 and errs["batch_stats"] <= 2e-3 and errs["opt_state"] <= 0.25, errs
    assert errs.get("ema_params", 0.0) <= 1e-3, errs


def test_unet_trainer_matches_jax_and_cross_resumes(setup) -> None:
    init = setup
    rj, cj = _jax("j2", resume=init, epochs=2)
    rt, ct = _port("t2", resume=init, epochs=2)
    _assert_close_runs(rj, cj, rt, ct)
    assert rt.parameters["final_epoch"] == 2 and abs(rt.parameters["best_val_score"] - rj.parameters["best_val_score"]) <= 1e-5
    for split in ("train", "val"):
        errs = metrics_table_errors(rj, rt, f"{split}_epoch2")
        for k, e in errs.items():
            bound = 1e-2 if k in ("iou", "pixel_accuracy") or k.endswith("_2d") else 1e-4
            assert e <= bound, (split, k, e)
    # epoch 1 in one package, epoch 2 in the other, against both in JAX
    _, cj1 = _jax("j1", resume=init, epochs=1)
    _, ct1 = _port("t1", resume=init, epochs=1)
    rjj, cjj = _jax("j1j2", resume=cj1, epochs=2)
    rjt, cjt = _port("j1t2", resume=cj1, epochs=2)
    rtj, ctj = _jax("t1j2", resume=ct1, epochs=2)
    _assert_close_runs(rjj, cjj, rjt, cjt)
    _assert_close_runs(rjj, cjj, rtj, ctj)
    # a resumed run restores the optimizer state: its first update is not
    # a fresh RMSprop's (which would be ~3·lr on every element)
    flat_j1, _ = flat_checkpoint(cj1)
    assert any(k.startswith("opt_state/") for k in flat_j1)


def test_unet_trainer_options_match_jax(setup) -> None:
    """--guard-quad, EMA (the validated view), the plateau drop and
    use_sample_weights (no table store: the mask-area weights), in both.
    With a learning rate of 1e-12 only the BatchNorm statistics move: val
    dice falls, the fifth validation drops the rate, and the guard vetoes
    both epochs (the untrained masks lose every val board) identically."""
    init = setup
    kw = dict(resume=init, epochs=2, guard_quad=True, ema_decay=0.5, use_sample_weights=True,
              validations_per_epoch=4, learning_rate=1e-12)
    rj, cj = _jax("jopt", **kw)
    rt, ct = _port("topt", **kw)
    assert scalar_errors(rj, rt) <= 1e-5
    lrs = [s["lr"] for s in rt.scalars() if "lr" in s]
    assert lrs[0] == pytest.approx(1e-12) and lrs[-1] == pytest.approx(1e-13)
    guards = [s for s in rt.scalars() if "guard_corner_err" in s]
    assert [g["guard_lost"] for g in guards] == [4, 4]
    # vetoed: both keep the epoch-0 checkpoint
    assert flat_checkpoint(ct)[1]["epoch"] == flat_checkpoint(cj)[1]["epoch"] == 0


def test_unet_trainer_adopts_the_checkpoints_architecture_and_refuses_finished_runs(setup) -> None:
    init = setup
    with pytest.raises(ValueError, match="no epochs would run"):
        _, ck = _port("t1", resume=init, epochs=1)
        _port("again", resume=ck, epochs=1)


def test_port_trainers_refuse_more_than_one_process(monkeypatch) -> None:
    from chessvision_tpu_torch.train import train_classifier

    with pytest.raises(NotImplementedError):
        ttrain.main(["--coordinator", "localhost:1234", "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        train_classifier.main(["--num-processes", "2", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError):
        ttrain.train_model(device="cpu")
