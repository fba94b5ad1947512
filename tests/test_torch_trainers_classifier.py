"""The port's classifier trainer end to end against the JAX package's, on
the CPU.

Both packages run ``train_model`` from the same JAX-written checkpoint
(ResNet18 width 8, epoch 0) on the same 64² squares (16 train, 13 val),
batch 8, float32, no augmentation, no mesh; the port with
``device="cpu"``.  The batch order is the same by construction.

Bounds, each with the figure measured when it was set.  With BatchNorm
in train mode (the default run and the cross-resumes): logged losses and
accuracies 2e-3 relative (measured 8.8e-4); final parameters over the tree
relative to the largest parameter 5e-3 (measured 2.1e-3); batch
statistics per leaf 2e-2 (measured 6.6e-3, after a cross-resume);
optimizer state over the tree 0.05 (measured 1.3e-2); metrics tables' continuous columns 2e-2, the PCA
embedding 5e-2 after each component's sign is aligned.  On the CPU the JAX
reference's train-mode BatchNorm statistics are not exact: XLA sums the
4 096–16 384 values of a channel in sequence and takes E[x²] − E[x]², so
its logits sit 1.7e-4 and its gradients up to 4.3e-2 (worst leaf) from a
float64 evaluation, the port's 5.8e-6 and 6.2e-6
(tests/test_torch_train_steps.py), and Adam carries that into each step.
With ``freeze_bn`` (the options run) that source is gone and the two
trainers agree to 1e-5 on everything (measured 7.6e-7).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.train import data as jdata
from chessvision_tpu.train import train_classifier as jtrain
from chessvision_tpu_torch.train import data as tdata
from chessvision_tpu_torch.train import train_classifier as ttrain
from tests._trainer_parity import (
    checkpoint_errors,
    cls_data,
    cls_init_checkpoint,
    flat_checkpoint,
    metrics_table_errors,
    scalar_errors,
)

COMMON = dict(batch_size=8, augment=False, use_mesh=False, collection_frequency=99, seed=3)


@pytest.fixture
def setup(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    monkeypatch.setattr(jdata, "load_squares", lambda *a, **k: cls_data(jdata))
    monkeypatch.setattr(tdata, "load_squares", lambda *a, **k: cls_data(tdata))
    return cls_init_checkpoint(tmp_path / "init.npz")


def _jax(name, **kw):
    return jtrain.train_model(model_dtype=jnp.float32, run_name=name, **{**COMMON, **kw})


def _port(name, **kw):
    return ttrain.train_model(model_dtype=torch.float32, device="cpu", run_name=name, **{**COMMON, **kw})


def _assert_close_runs(run_a, ck_a, run_b, ck_b, tol: float | None = None) -> None:
    """Train-mode BatchNorm bounds, or ``tol`` for everything."""
    assert scalar_errors(run_a, run_b) <= (tol or 2e-3)
    errs = checkpoint_errors(ck_a, ck_b)
    assert errs["params"] <= (tol or 5e-3) and errs["batch_stats"] <= (tol or 2e-2), errs
    assert errs["opt_state"] <= (tol or 0.05) and errs.get("ema_params", 0.0) <= (tol or 5e-3), errs


def test_classifier_trainer_matches_jax_and_cross_resumes(setup) -> None:
    init = setup
    rj, cj = _jax("j2", resume=init, epochs=2, lr_step_size=1)
    rt, ct = _port("t2", resume=init, epochs=2, lr_step_size=1)
    _assert_close_runs(rj, cj, rt, ct)
    for split in ("train", "val"):
        errs = metrics_table_errors(rj, rt, f"{split}_epoch2")
        for k, e in errs.items():
            bound = 5e-2 if k.endswith("_2d") else 2e-2
            assert e <= bound, (split, k, e)
    _, cj1 = _jax("j1", resume=init, epochs=1, lr_step_size=1)
    _, ct1 = _port("t1", resume=init, epochs=1, lr_step_size=1)
    rjj, cjj = _jax("j1j2", resume=cj1, epochs=2, lr_step_size=1)
    rjt, cjt = _port("j1t2", resume=cj1, epochs=2, lr_step_size=1)
    rtj, ctj = _jax("t1j2", resume=ct1, epochs=2, lr_step_size=1)
    _assert_close_runs(rjj, cjj, rjt, cjt)
    _assert_close_runs(rjj, cjj, rtj, ctj)
    # the step schedule's count came back with the optimizer state: the
    # resumed runs' second epoch runs at lr·0.1
    leaves = [v for k, v in sorted(flat_checkpoint(cjt)[0].items()) if k.startswith("opt_state/")]
    assert int(leaves[0]) == int(leaves[-1]) == 4  # Adam's count and the schedule's


def test_classifier_trainer_options_match_jax(setup) -> None:
    """EMA, use_sample_weights (no table store: inverse class frequency),
    label smoothing, freeze_bn and the warm-up cosine schedule, in both."""
    init = setup
    kw = dict(resume=init, epochs=3, ema_decay=0.5, use_sample_weights=True, label_smoothing=0.1, freeze_bn=True,
              schedule_kind="cosine")
    rj, cj = _jax("jopt", **kw)
    rt, ct = _port("topt", **kw)
    _assert_close_runs(rj, cj, rt, ct, tol=1e-5)
    flat_t, _ = flat_checkpoint(ct)
    assert any(k.startswith("ema_params/") for k in flat_t)
    # freeze_bn: the running statistics are the initial checkpoint's
    flat_0, _ = flat_checkpoint(init)
    assert all(np.array_equal(v, flat_t[k]) for k, v in flat_0.items() if k.startswith("batch_stats/"))
