"""Both port trainers over two gloo processes on the CPU, through their
command lines (``--coordinator/--num-processes/--process-id``), against
the same trainers in one process on the same seeded data (the tiny
datasets of tests/_trainer_parity.py; tests/_torch_mesh_worker.py runs a
rank).  Mirrors tests/test_mesh_distributed.py's trainer test.

Rank 0 alone writes the run and its checkpoints.  The checkpoints of one
epoch (UNet base 4, batch 4, four steps with two validations; ResNet18
width 8, batch 8, two steps) equal the one-process run's: best score
to 1e-6; statistics 1e-5 relative (measured 2.6e-7 UNet, 5.0e-6 ResNet);
UNet parameters 1e-5 relative (measured 1.3e-6); ResNet parameters 1e-4
absolute (measured 1.2e-5: Adam moves an element whose gradient is at
rounding level by up to lr = 1e-3 a step, 2.8e-4 relative on the worst
small leaf).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chessvision_tpu_torch import weights
from chessvision_tpu_torch.checkpoint import load_checkpoint
from tests import _torch_mesh_worker as worker

REPO = Path(__file__).resolve().parent.parent


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def _checkpoint(store: Path, project: str, run: str):
    return load_checkpoint(str(store / "projects" / project / "runs" / run / "bulk" / "checkpoint.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", CVTPU_STORE_ROOT=str(store))
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "CVTPU_DISTRIBUTED"):
        env.pop(v, None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_mesh_worker.py"), "trainers", str(r), "2", str(port)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    # the one-process runs, meanwhile
    mp = pytest.MonkeyPatch()
    mp.setenv("CVTPU_STORE_ROOT", str(store))
    try:
        import chessvision_tpu_torch.train.data as data_lib

        saved = data_lib.load_board_extraction, data_lib.load_squares
        worker.patch_datasets()
        from chessvision_tpu_torch.train import train_classifier, train_unet

        train_unet.main(worker.trainer_argv("unet", "one"))
        train_classifier.main(worker.trainer_argv("resnet18", "one"))
    finally:
        data_lib.load_board_extraction, data_lib.load_squares = saved
        mp.undo()
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("trainer ranks timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return store, logs


@pytest.mark.parametrize("project", ["chessvision-segmentation", "chessvision-classification"])
def test_mesh_trainer_checkpoint_equals_one_process(runs, project) -> None:
    store, _ = runs
    (mv, mm), (ov, om) = _checkpoint(store, project, "mesh"), _checkpoint(store, project, "one")
    assert mm["best_val_score"] == pytest.approx(om["best_val_score"], rel=1e-6, abs=1e-6)
    assert mm["epoch"] == om["epoch"] == 1
    got, want = (weights._flatten({k: v[k] for k in ("params", "batch_stats")}) for v in (mv, ov))
    assert got.keys() == want.keys()
    for k in want:
        if k[0] == "batch_stats":
            assert _rel(want[k], got[k]) <= 1e-5, k
        elif project == "chessvision-segmentation":
            assert _rel(want[k], got[k]) <= 1e-5, k
        else:
            assert np.max(np.abs(want[k] - got[k])) <= 1e-4, k


def test_only_rank_zero_owns_the_run(runs) -> None:
    store, logs = runs
    for project in ("chessvision-segmentation", "chessvision-classification"):
        names = sorted(p.name for p in (store / "projects" / project / "runs").iterdir())
        assert names == ["mesh", "one"], names
    assert "Checkpoint" in logs[0] and "Checkpoint" not in logs[1]
