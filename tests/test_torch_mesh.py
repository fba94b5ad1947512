"""The port's data-parallel layer (``chessvision_tpu_torch/parallel``) on
the CPU, mirroring tests/test_mesh_distributed.py and
tests/test_steps_sharded.py.

- the init gates: no environment is a no-op, an explicit bad coordinator
  raises, an environment marker without a cluster falls through;
- the slice and pad arithmetic against the JAX functions;
- two gloo processes (tests/_torch_mesh_worker.py, a file store) run one
  segmentation step (UNet base 4, 32², B=8 global), one classifier step
  (ResNet18 width 8, 64², B=16 global) and ``Engine(mesh=…).process_batch``
  (stub extractor and YoloCls width 8, 3 frames padded to 4).  The models
  are the port's, seeded; the JAX package gets their variables through
  ``weights.torch_to_flax``.

Bounds: across ranks everything is equal bit for bit.  Against the
port's one-process step on the same global batch (the ranks sum each
channel's statistics and the gradients in two halves): loss, metrics and
parameter norm 1e-6 relative (measured 1.6e-7); BatchNorm statistics
1e-5 (measured 7.3e-7); UNet parameters 2e-5 (measured 6.0e-6: RMSprop
scales a gradient at rounding level up to a step); ResNet parameters
within 2.05·lr (Adam's first step moves each element by ±lr, measured
1.2e-4 relative).

Against the JAX package's unsharded step: loss and metrics 1e-5 relative
and the UNet's parameter norm 1e-4 (the bounds of
tests/test_torch_train_steps.py and tests/test_mesh_distributed.py); UNet
statistics 3e-5 (measured 1.5e-5 on the 2×2 planes of the deepest block,
where each channel averages 32 values); ResNet statistics 1e-4 and
parameters within 2.05·lr.  Single UNet parameters are not compared with
JAX: a BatchNorm bias whose gradient the next BatchNorm all but cancels
takes RMSprop's step on rounding noise (3.8e-3 relative on this seed;
ROADMAP §3 on JAX's train-mode statistics).

The engine's FENs and found flags equal the one-process engine's and the
JAX package's; its probabilities are within 1e-5 of the one-process
engine and 1e-3 of JAX (the atol of tests/test_torch_engine.py).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chessvision_tpu import models as jmodels
from chessvision_tpu.parallel import mesh as jmesh
from chessvision_tpu.train import steps as jsteps
from chessvision_tpu_torch import models as tmodels
from chessvision_tpu_torch import weights
from chessvision_tpu_torch.parallel import mesh as tmesh
from tests import _torch_mesh_worker as worker

REPO = Path(__file__).resolve().parent.parent


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


# -- init gates ------------------------------------------------------------------------


def test_no_cluster_env_is_noop(monkeypatch) -> None:
    for v in (*tmesh._ENV_MARKERS, "CVTPU_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert tmesh.initialize_distributed() == 0
    assert not torch.distributed.is_initialized()
    mesh = tmesh.create_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.backend) == (1, 0, torch.device("cpu"), None)


def test_explicit_bad_coordinator_raises() -> None:
    """A misconfigured explicit multi-process job fails loudly."""
    with pytest.raises(Exception):
        tmesh.initialize_distributed("127.0.0.1:1", 2, 1, backend="gloo", timeout_s=0.5)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        tmesh.initialize_distributed("127.0.0.1:1", None, None)


@pytest.mark.parametrize("marker", ["CVTPU_DISTRIBUTED", "COORDINATOR_ADDRESS", "MASTER_ADDR"])
def test_env_marker_autodetect_falls_through(monkeypatch, marker) -> None:
    """Cluster markers without a cluster behind them: one process."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(marker, "1" if marker == "CVTPU_DISTRIBUTED" else "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.initialize_distributed(backend="gloo") == 0
    assert not torch.distributed.is_initialized()


# -- arithmetic against the JAX package -------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_process_local_batch_slice_matches_jax(monkeypatch, n) -> None:
    for global_batch in (1, 6, 8, 13, 128):
        for idx in range(n):
            monkeypatch.setattr(jmesh.jax, "process_count", lambda: n)
            monkeypatch.setattr(jmesh.jax, "process_index", lambda: idx)
            want = jmesh.process_local_batch_slice(global_batch)
            got = tmesh.process_local_batch_slice(global_batch, tmesh.Mesh(n, idx, torch.device("cpu")))
            assert got == want, (global_batch, n, idx)


@pytest.mark.parametrize("b,multiple", [(6, 8), (8, 8), (3, 2), (1, 4), (5, 1)])
def test_pad_to_multiple_matches_jax(b, multiple) -> None:
    batch = np.random.default_rng(b).integers(0, 256, (b, 4, 4, 3), np.uint8)
    got, n = tmesh.pad_to_multiple(batch, multiple)
    want, wn = jmesh.pad_to_multiple(batch, multiple)
    assert n == wn and np.array_equal(got, want)


def test_one_process_helpers_are_identities() -> None:
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    assert np.array_equal(tmesh.make_global_batch(None, x).numpy(), x)
    mesh1 = tmesh.create_mesh(device="cpu")
    assert np.array_equal(tmesh.make_global_batch(mesh1, x).numpy(), x)
    got = tmesh.host_gather(mesh1, {"a": torch.from_numpy(x), "b": (x[:2], torch.ones(2, dtype=torch.bool))})
    assert np.array_equal(got["a"], x) and np.array_equal(got["b"][0], x[:2]) and got["b"][1].dtype == np.bool_
    assert not tmesh.spans_processes(mesh1) and not tmesh.spans_processes(None)


# -- two gloo processes --------------------------------------------------------------------


def _port_models() -> dict[str, torch.nn.Module]:
    torch.manual_seed(0)
    yolo, _ = tmodels.create_classifier("yolo", width=8)
    return {"unet.pt": tmodels.UNet(base=4), "resnet.pt": tmodels.resnet18(width=8), "yolo.pt": yolo}


def _jax_state(jmodel, variables, tx):
    return jsteps.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], batch_stats=variables["batch_stats"], tx=tx
    )


class _FixedQuadJax:
    """The JAX engine's counterpart of ``worker.FixedQuadExtractor``; a zero
    times the input keeps XLA from folding the pipeline behind it."""

    def __init__(self) -> None:
        self._logits = jnp.asarray(worker.FixedQuadExtractor().logits.numpy())

    def apply(self, variables, x, **kw):
        return jnp.broadcast_to(self._logits[None, :, :, None], (x.shape[0], 256, 256, 1)) + 0.0 * x[..., :1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Seeded port models (the JAX package gets the same variables through
    ``weights.torch_to_flax``); both ranks' records and the one-process
    ones."""
    root = tmp_path_factory.mktemp("mesh")
    mods = _port_models()
    sds = {name: m.state_dict() for name, m in mods.items()}
    for name, sd in sds.items():
        torch.save(sd, root / name)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "CVTPU_DISTRIBUTED"):
        env.pop(v, None)
    init_file = root / "store"
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_mesh_worker.py"), str(r), "2", str(init_file), str(root), str(root)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    # the one-process reference runs while the ranks do
    one = {}
    one.update(worker.seg_step(None, sds["unet.pt"]))
    one.update(worker.cls_step(None, sds["resnet.pt"]))
    one.update(worker.engine_record(None, sds["yolo.pt"]))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("mesh worker timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    jvars = {name: weights.torch_to_flax(m) for name, m in mods.items()}
    return ranks, one, jvars


def test_ranks_split_the_batch_and_agree_exactly(two_ranks) -> None:
    ranks, _, _ = two_ranks
    assert [int(r["rank"]) for r in ranks] == [0, 1] and all(int(r["size"]) == 2 for r in ranks)
    assert ranks[0]["slice"].tolist() == [0, 4] and ranks[1]["slice"].tolist() == [4, 8]
    a, b = ranks
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("rank", "slice"):
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("prefix,metric", [("seg", "dice"), ("cls", "accuracy")])
def test_mesh_step_equals_one_process_step(two_ranks, prefix, metric) -> None:
    ranks, one, _ = two_ranks
    got = ranks[0]
    for k in ("loss", metric, "param_norm"):
        assert _rel(one[f"{prefix}/{k}"], got[f"{prefix}/{k}"]) <= 1e-6, k
    state_keys = [k for k in one if k.startswith(f"{prefix}/state/")]
    assert state_keys and set(state_keys) <= set(got)
    for k in state_keys:
        if "/batch_stats/" in k:
            assert _rel(one[k], got[k]) <= 1e-5, k
        elif prefix == "seg":
            assert _rel(one[k], got[k]) <= 2e-5, k
        else:
            assert np.max(np.abs(one[k] - got[k])) <= 2.05 * worker.CLS_LR, k


def test_mesh_seg_step_equals_jax_unsharded_step(two_ranks) -> None:
    ranks, _, jvars = two_ranks
    got = ranks[0]
    seg = _jax_state(
        jmodels.UNet(base=4, dtype=jnp.float32), jvars["unet.pt"],
        jsteps.make_optimizer("rmsprop", worker.SEG_LR, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0),
    )
    x, y = worker.seg_batch()
    new, m = jsteps.make_seg_train_step()(seg, jnp.asarray(x), jnp.asarray(y))
    for k in ("loss", "dice"):
        assert _rel(m[k], got[f"seg/{k}"]) <= 1e-5, k
    pnorm = float(jnp.sqrt(sum(jnp.vdot(p, p) for p in jax.tree.leaves(new.params))))
    assert _rel(pnorm, got["seg/param_norm"]) <= 1e-4
    want = weights._flatten({"params": jax.tree.map(np.asarray, new.params),
                             "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    for k, v in want.items():
        if k[0] == "batch_stats":
            assert _rel(v, got["seg/state/" + "/".join(k)]) <= 3e-5, k


def test_mesh_cls_step_equals_jax_unsharded_step(two_ranks) -> None:
    ranks, _, jvars = two_ranks
    got = ranks[0]
    cls = _jax_state(jmodels.resnet18(width=8, dtype=jnp.float32), jvars["resnet.pt"], optax.adam(worker.CLS_LR))
    x, labels = worker.cls_batch()
    new, m = jsteps.make_cls_train_step()(cls, jnp.asarray(x), jnp.asarray(labels.astype(np.int32)))
    for k in ("loss", "accuracy"):
        assert _rel(m[k], got[f"cls/{k}"]) <= 1e-5, k
    want = weights._flatten({"params": jax.tree.map(np.asarray, new.params),
                             "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    for k, v in want.items():
        g = got["cls/state/" + "/".join(k)]
        if k[0] == "batch_stats":
            assert _rel(v, g) <= 1e-4, k
        else:
            assert np.max(np.abs(v - g)) <= 2.05 * worker.CLS_LR, k


def test_mesh_engine_equals_one_process_and_jax(two_ranks) -> None:
    ranks, one, jvars = two_ranks
    got = ranks[0]
    assert got["engine/fens"].tolist() == one["engine/fens"].tolist()
    assert np.array_equal(got["engine/found"], one["engine/found"]) and got["engine/found"].all()
    np.testing.assert_allclose(got["engine/probabilities"], one["engine/probabilities"], atol=1e-5)
    np.testing.assert_allclose(got["engine/quadrangle"], one["engine/quadrangle"], atol=1e-4)
    assert got["engine/board_image"].shape == (3, 512, 512)

    from chessvision_tpu.engine import Engine as JaxEngine

    classifier, spec = jmodels.create_classifier("yolo", dtype=jnp.float32, width=8)
    jax_engine = JaxEngine(
        _FixedQuadJax(), {}, classifier, jvars["yolo.pt"],
        classifier_outputs_probabilities=spec.outputs_probabilities, refine_grid="arbitrate", arbitrate_chunk=2,
    )
    want = jax_engine.process_batch(worker.engine_batch(), threshold=0.5)
    assert got["engine/fens"].tolist() == list(want.fens)
    assert got["engine/found"].tolist() == [bool(f) for f in want.board_found]
    np.testing.assert_allclose(got["engine/probabilities"], np.asarray(want.probabilities), atol=1e-3)
