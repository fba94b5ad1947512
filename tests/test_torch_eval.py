"""The port's evaluation against the JAX package's, on the CPU.

- the metric functions of tests/test_eval_metrics.py, each case run
  through both packages (equal results, and the reference's values);
- ``evaluate_model`` of both packages on one tmp ``test_root`` of 4
  synthetic frames in two native shapes (256² and 320², so the grouping by
  shape and the padded tails are exercised; batch 2), each package's engine
  with the stub models of tests/test_engine.py: aggregates equal (times
  aside) and the per-image tables equal (artifact paths compared by file
  name; the port draws its board renders with cv2);
- ``evaluate_segmentation`` of both on a tiny split: equal dice and IoU
  (float32 models with the same weights, 1e-6);
- the render artifacts.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from chessvision_tpu import models as jmodels
from chessvision_tpu import runstore as jrunstore
from chessvision_tpu.chessboard import fen_to_labels
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu.eval import evaluate as jev
from chessvision_tpu.train import data as jdata
from chessvision_tpu_torch import constants, runstore, weights
from chessvision_tpu_torch import models as tmodels
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.eval import evaluate as tev
from chessvision_tpu_torch.eval import render
from chessvision_tpu_torch.synthetic import write_test_root
from chessvision_tpu_torch.train import data as tdata

START_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"
STUB_QUAD = [[32, 28], [224, 30], [226, 228], [30, 226]]


@pytest.fixture(autouse=True)
def store_root(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))


def _topk_case(name: str) -> tuple[np.ndarray, str]:
    li = constants.LABEL_INDICES
    p = np.zeros((64, 13), np.float32)
    if name == "empty board":
        fen = "8/8/8/8/8/8/8/8"
        p[:32, li["f"]] = 1.0
        p[32:48, li["p"]], p[32:48, li["f"]] = 1.0, 0.9
        p[48:, li["P"]], p[48:, li["p"]], p[48:, li["f"]] = 1.0, 0.9, 0.8
    elif name == "pawn rank":
        fen = "8/8/8/8/8/8/PPPPPPPP/8"
        p[48:56, li["P"]] = 1.0
        p[list(range(48)) + list(range(56, 64)), li["f"]] = 1.0
    else:
        fen = START_FEN
        for sq, lab in enumerate(fen_to_labels(fen)):
            if sq < 8:
                p[sq, li["p"]], p[sq, li["q"]], p[sq, li[lab]] = 0.9, 0.8, 0.7
            elif sq >= 56:
                p[sq, li["P"]], p[sq, li[lab]], p[sq, li["Q"]] = 0.9, 0.8, 0.7
            else:
                p[sq, li[lab]], p[sq, li["f"]], p[sq, li["p"]] = 0.9, 0.8, 0.7
    return p, fen


@pytest.mark.parametrize("case,k,want", [
    ("empty board", 3, [0.5, 0.75, 1.0]),
    ("pawn rank", 1, [1.0]),
    ("pawn rank", 5, [1.0] * 5),
    ("start position with errors", 3, [40 / 64, 57 / 64, 1.0]),
])
def test_topk_accuracy_matches_jax(case, k, want) -> None:
    p, fen = _topk_case(case)
    got = tev.compute_model_topk_accuracy(p, fen, k=k)
    ref = jev.compute_model_topk_accuracy(p, fen, k=k)
    assert got.k == ref.k == k and list(got.accuracies) == list(ref.accuracies)
    np.testing.assert_allclose(got.accuracies, want, atol=1e-6)
    assert (got.top_1, got.top_2, got.top_3) == (ref.top_1, ref.top_2, ref.top_3)


@pytest.mark.parametrize("fen,off,correct", [
    (START_FEN, "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNQ", 63),
    ("8/8/8/8/8/8/8/8", "q7/8/8/8/8/8/8/8", 63),
    ("8/8/8/8/4Q3/8/8/8", "8/8/8/8/8/8/8/8", 63),
])
def test_labels_and_position_accuracy_match_jax(fen, off, correct) -> None:
    assert tev.board_to_labels(fen) == jev.board_to_labels(fen)
    for pred in (fen, off):
        got, ref = tev.compute_position_accuracy(pred, fen), jev.compute_position_accuracy(pred, fen)
        assert (got.accuracy, got.num_correct, got.total_squares) == (ref.accuracy, ref.num_correct, ref.total_squares)
    assert tev.compute_position_accuracy(off, fen).num_correct == correct


def _fill(pts) -> np.ndarray:
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    inside = np.ones((256, 256), bool)
    pts = np.asarray(pts, np.float64)
    for i in range(4):
        (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % 4]
        inside &= (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0) >= 0
    return np.where(inside, 8.0, -8.0).astype(np.float32)


def _start_logits() -> np.ndarray:
    out = np.full((64, 13), -5.0, np.float32)
    for i, lab in enumerate(fen_to_labels(START_FEN)):
        out[i, constants.LABEL_INDICES[lab]] = 5.0
    out[3, constants.LABEL_INDICES["k"]] = 4.0  # the queen's square: a second choice for top-2
    return out


class _Stub(nn.Module):
    def __init__(self, logits: np.ndarray, kind: str) -> None:
        super().__init__()
        self.register_buffer("logits", torch.from_numpy(logits))
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "extractor":
            return self.logits[None, :, :, None].expand(x.shape[0], 256, 256, 1)
        return self.logits.repeat(x.shape[0] // 64, 1)


class _JaxStub:
    def __init__(self, logits: np.ndarray, kind: str) -> None:
        self._logits, self._kind = jnp.asarray(logits), kind

    def apply(self, variables, x, **kw):
        if self._kind == "extractor":
            return jnp.broadcast_to(self._logits[None, :, :, None], (x.shape[0], 256, 256, 1)) + 0.0 * x[..., :1]
        return jnp.tile(self._logits, (x.shape[0] // 64, 1)) + 0.0 * x[:, 0, 0, :]


def test_evaluate_model_matches_jax(tmp_path) -> None:
    root = write_test_root(tmp_path / "test", 4, seed=0, sizes=(256, 320))
    # one board with the wrong truth, so accuracies are not all 1
    (root / "batch0" / "ground_truth" / "img01.txt").write_text("8/8/8/8/8/8/8/8")
    for i in (0, 2, 3):
        (root / "batch0" / "ground_truth" / f"img{i:02d}.txt").write_text(START_FEN)
    seg, cls = _fill(STUB_QUAD), _start_logits()
    port = SimpleNamespace(engine=Engine(_Stub(seg, "extractor"), _Stub(cls, "classifier"), device="cpu"))
    ref = SimpleNamespace(engine=JaxEngine(_JaxStub(seg, "extractor"), {}, _JaxStub(cls, "classifier"), {}))
    trun, jrun = runstore.init("chessvision-testing", "port"), jrunstore.init("chessvision-testing", "jax")
    got = tev.evaluate_model(cv_model=port, test_root=root, batch_size=2, include_metrics_table=True, run=trun)
    want = jev.evaluate_model(cv_model=ref, test_root=root, batch_size=2, include_metrics_table=True, run=jrun)

    def timeless(a):
        return {k: v for k, v in a.items() if not k.startswith("avg_time")}

    assert timeless(got) == timeless(want)
    assert got["num_images"] == 4 and got["extraction_failures"] == 0 and 0 < got["top_1_accuracy"] < 1
    tt, jt = trun.read_metrics_table("test_per_image"), jrun.read_metrics_table("test_per_image")
    assert tt.keys() == jt.keys()
    for k in tt:
        if k.endswith("_image"):
            assert [Path(p).name for p in tt[k]] == [Path(p).name for p in jt[k]]
            assert all(Path(p).exists() for p in tt[k])
        else:
            assert list(tt[k]) == list(jt[k]), k
    assert list(tt["example_id"]) == [f"img{i:02d}.JPG" for i in range(4)]


def test_evaluate_segmentation_matches_jax(tmp_path, monkeypatch) -> None:
    def tiny(mod):
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (5, 64, 64, 3), np.uint8)
        masks = (rng.random((5, 64, 64)) > 0.5).astype(np.float32)
        return mod.SegmentationData(imgs[:3], masks[:3], imgs[3:], masks[3:], ["a", "b", "c"], ["d", "e"])

    monkeypatch.setattr(jdata, "load_board_extraction", lambda *a, **k: tiny(jdata))
    monkeypatch.setattr(tdata, "load_board_extraction", lambda *a, **k: tiny(tdata))
    jmod = jmodels.UNet(base=4, dtype=jnp.float32)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tmod = tmodels.UNet(base=4)
    tmod.load_state_dict(weights.flax_to_torch(jax.tree.map(np.asarray, variables), tmod))
    got = tev.evaluate_segmentation(cv_model=SimpleNamespace(board_extractor=(tmod.eval(), None)))
    want = jev.evaluate_segmentation(cv_model=SimpleNamespace(board_extractor=(jmod, None, variables)))
    assert got.keys() == want.keys() and got["num_images"] == want["num_images"] == 2
    for k in ("val_mask_dice", "val_mask_iou"):
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_render_artifacts(tmp_path) -> None:
    import cv2

    paths = render.save_eval_artifacts(tmp_path, "x.JPG", fen=START_FEN, binary_mask=np.zeros((8, 8), np.uint8),
                                       board_image=np.full((16, 16), 7, np.uint8))
    assert sorted(paths) == ["binary_mask", "extracted_board", "predicted_board"]
    png = cv2.imread(str(paths["predicted_board"]))
    assert png.shape == (400, 400, 3) and png.std() > 10  # squares and pieces drawn
    assert render.save_eval_artifacts(tmp_path, "y.JPG") == {}
