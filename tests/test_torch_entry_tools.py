"""The port's last two entry points against the JAX package, on the CPU.

- ``tools/make_hard_example_weights`` on a seeded synthetic squares root
  with the committed classifier at float32: the ``sample_weight`` column
  it writes equals, within atol 1e-4, the weights computed here from the
  JAX package's float32 ResNet18 on the same squares (probabilities agree
  to 1e-5, as ``test_torch_models.py`` states, and the weight is
  ``1 + 9·(1 − p)`` over its mean), the hard count (p_true < 0.9) is equal,
  and the classifier trainer's ``sample_weights_for_ids`` reads it back;
- ``tools/loadtest_server`` at ``--device cpu``, a handful of requests two
  at a time (the micro-batcher capped at 2, so that warming every batch
  shape costs three CPU frames): the JAX script's keys, the card fields,
  and a served FEN equal to ``process_batch``'s on the decoded frame;
- both raise without a GPU unless asked for the CPU, and so does
  ``tools/memory_peaks`` (the card only).
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu import checkpoint as jcheckpoint
from chessvision_tpu.models.resnet import resnet18 as flax_resnet18
from chessvision_tpu.train import data as jdata
from chessvision_tpu_torch import constants
from chessvision_tpu_torch.serve import server as server_mod
from chessvision_tpu_torch.synthetic import write_squares_dataset
from chessvision_tpu_torch.tools import loadtest_server, make_hard_example_weights, memory_peaks

LOADTEST_KEYS = ("mode", "requests", "concurrency", "req_per_sec", "p50_ms", "p95_ms", "wall_s")


def test_hard_example_weights_match_jax(tmp_path, monkeypatch, capsys) -> None:
    root = write_squares_dataset(tmp_path / "data", 3, 1, seed=0)
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    assert make_hard_example_weights.main(["--device", "cpu", "--dtype", "float32", "--data-root", str(root)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("wrote sample_weight to ") and lines[1] == "device: cpu, power limit: None W"

    data = jdata.load_squares(root)
    variables = jcheckpoint.load_checkpoint(constants.BEST_CLASSIFIER_WEIGHTS)[0]
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    logits = flax_resnet18(dtype=jnp.float32).apply(variables, jnp.asarray(data.train_images, jnp.float32)[..., None] / 255.0)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    p_true = probs[np.arange(len(data.train_labels)), data.train_labels]
    w = 1.0 + 9.0 * (1.0 - p_true)
    want = dict(zip(data.train_ids, w / w.mean()))
    assert f"{int((p_true < 0.9).sum())} hard examples" in lines[0]

    from chessvision_tpu_torch.train import data as data_lib
    from chessvision_tpu_torch.train.tables import get_or_create_classification_tables, sample_weights_for_ids

    train = get_or_create_classification_tables()["train"]
    got = dict(zip(train["example_id"], train["sample_weight"]))
    assert got.keys() == want.keys() and len(got) == 39
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), atol=1e-4)
    # what the classifier trainer reads with --use-sample-weights
    port_data = data_lib.load_squares(root)
    read = sample_weights_for_ids(train, port_data.train_ids)
    assert read is not None
    np.testing.assert_array_equal(read, [got[k] for k in port_data.train_ids])


def test_loadtest_server_on_the_cpu(tmp_path, monkeypatch, capsys) -> None:
    monkeypatch.setenv("CVTPU_DATA_ROOT", str(tmp_path))  # no test photo there: the synthetic frame
    monkeypatch.setattr(server_mod._MicroBatcher, "__init__",
                        functools.partialmethod(server_mod._MicroBatcher.__init__, max_batch=2))
    assert loadtest_server.main(["--device", "cpu", "--requests", "4", "--concurrency", "2"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    rec = json.loads(line)
    assert all(k in rec for k in LOADTEST_KEYS)
    assert rec["mode"] == "local" and rec["requests"] == 4 and rec["concurrency"] == 2
    assert rec["req_per_sec"] > 0 and 0 < rec["p50_ms"] <= rec["p95_ms"]
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None and rec["backend"] == "cpu"
    assert rec["image"].startswith("synthetic board_frames seed 1")
    # the tool holds every response to process_batch's FEN; the frame's board is found
    assert rec["fen"]


@pytest.mark.parametrize("tool", [loadtest_server, make_hard_example_weights, memory_peaks])
def test_entry_tools_raise_without_a_gpu(tool, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
