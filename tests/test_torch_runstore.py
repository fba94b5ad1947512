"""The port's runstore, dataset tables and data loaders, mirroring
tests/test_runstore.py (apart from the viewer) and the table and loader
tests of tests/test_dataset_tables.py, on the CPU; plus a store written by
one package read by the other (same layout, same CVTPU_STORE_ROOT)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chessvision_tpu import runstore as jrunstore
from chessvision_tpu.train import data as jdata
from chessvision_tpu.train import tables as jtables
from chessvision_tpu_torch.runstore import Run, Table, init, list_runs
from chessvision_tpu_torch.runstore import metrics as collectors
from chessvision_tpu_torch.synthetic import write_segmentation_dataset, write_squares_dataset
from chessvision_tpu_torch.train import data as data_lib
from chessvision_tpu_torch.train import tables as ttables


@pytest.fixture(autouse=True)
def store_root(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    return tmp_path / "store"


def _table(n=10) -> Table:
    rng = np.random.default_rng(0)
    return Table(
        "proj",
        "ds",
        "initial",
        {
            "image": rng.integers(0, 255, (n, 4, 4), np.uint8),
            "label": rng.integers(0, 13, n).astype(np.int64),
            "path": np.asarray([f"img_{i}.jpg" for i in range(n)], object),
        },
    )


def test_table_save_load_roundtrip() -> None:
    t = _table().save()
    t2 = Table.load("proj", "ds", "initial")
    assert len(t2) == len(t)
    np.testing.assert_array_equal(t2["image"], t["image"])
    np.testing.assert_array_equal(t2["label"], t["label"])
    assert list(t2["path"]) == list(t["path"]) and list(t2["example_id"]) == list(t["example_id"])
    assert Table.exists("proj", "ds", "initial") and not Table.exists("proj", "ds", "nope")


def test_table_split_filter_join_and_sampler() -> None:
    t = _table(20)
    tr1, va1 = t.split(0.1, seed=0, names=("train", "val"))
    tr2, _ = t.split(0.1, seed=0, names=("train", "val"))
    assert list(tr1["example_id"]) == list(tr2["example_id"]) and len(va1) == 2
    assert tr1.lineage == {"op": "select", "parents": [t.url], "indices": 18}
    even = t.filter(t["label"] % 2 == 0, "even")
    odd = t.filter(lambda r: r["label"] % 2 == 1, "odd")
    merged = even.join(odd, "merged")
    assert len(merged) == 20 and len(merged.lineage["parents"]) == 2
    small = _table(4)
    small.with_column("sample_weight", np.array([0.0, 0.0, 0.0, 1.0]))
    assert (small.create_sampler(np.random.default_rng(0))(100) == 3).all()


def test_run_lifecycle() -> None:
    run = init("proj", "r1", parameters={"lr": 1e-3, "epochs": 5}, description="test")
    assert run.parameters["lr"] == 1e-3 and run.parameters["status"] == "running"
    run.log({"val_dice": 0.9, "step": 1})
    run.log({"val_dice": torch.tensor(0.95), "step": 2})
    assert [s["val_dice"] for s in run.scalars()] == [0.9, pytest.approx(0.95)]
    run.set_parameters({"best_val_score": 0.95})
    run.set_status_completed()
    assert run.parameters["status"] == "completed" and run.parameters["best_val_score"] == 0.95
    assert "r1" in list_runs("proj") and run.bulk_data_url.exists()


def test_metrics_tables_and_embedding_reduction_match_jax() -> None:
    n = 12
    emb = np.random.default_rng(0).normal(size=(n, 32)).astype(np.float32)
    cols = {"example_id": np.asarray([f"e{i}" for i in range(n)], object),
            "loss": np.linspace(0, 1, n).astype(np.float32), "embedding": emb}
    run = init("proj", "r2")
    run.write_metrics_table("val_epoch5", cols)
    assert run.list_metrics_tables() == ["val_epoch5"]
    run.reduce_embeddings("val_epoch5", "embedding", n_components=2)
    got = run.read_metrics_table("val_epoch5")
    assert "embedding_2d" in got and got["embedding_2d"].shape == (n, 2) and "embedding" not in got
    jrun = jrunstore.init("proj", "r2-jax")
    jrun.write_metrics_table("val_epoch5", cols)
    jrun.reduce_embeddings("val_epoch5", "embedding", n_components=2)
    want = jrun.read_metrics_table("val_epoch5")
    np.testing.assert_array_equal(got["embedding_2d"], want["embedding_2d"])


def test_a_store_written_by_one_package_is_read_by_the_other() -> None:
    run = init("proj", "port-run", parameters={"lr": 0.1})
    run.log({"loss": 1.5})
    run.write_metrics_table("t", {"example_id": np.asarray(["a", "b"], object), "v": np.arange(2.0), "m": np.eye(2)})
    jrun = jrunstore.Run("proj", "port-run")
    assert jrun.parameters["lr"] == 0.1 and jrun.scalars() == [{"loss": 1.5}]
    back = jrun.read_metrics_table("t")
    np.testing.assert_array_equal(back["m"], np.eye(2)) and list(back["example_id"]) == ["a", "b"]
    jrunstore.Table("proj", "ds", "jax-table", {"x": np.arange(3)}).save()
    t = Table.load("proj", "ds", "jax-table")
    np.testing.assert_array_equal(t["x"], np.arange(3))
    assert list(t["example_id"]) == ["jax-table:0", "jax-table:1", "jax-table:2"]
    assert sorted(list_runs("proj")) == sorted(jrunstore.runs.list_runs("proj"))
    assert isinstance(run, Run)


def test_collectors_shapes() -> None:
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(5, 8, 8)).astype(np.float32))
    targets = torch.from_numpy((rng.random((5, 8, 8)) > 0.5).astype(np.float32))
    assert collectors.segmentation_loss_per_sample(logits, targets)["loss"].shape == (5,)
    iou = collectors.segmentation_quality(logits, targets)["iou"]
    assert iou.shape == (5,) and bool(((iou >= 0) & (iou <= 1)).all())
    cm = collectors.classification_metrics(torch.from_numpy(rng.normal(size=(6, 13)).astype(np.float32)), torch.arange(6))
    assert cm["loss"].shape == (6,) and cm["predicted"].dtype == torch.int32
    te = collectors.to_numpy(collectors.top2_margin_and_entropy(torch.full((3, 13), 1 / 13)))
    np.testing.assert_allclose(te["top_2_confidence_difference"], 0.0, atol=1e-6)
    np.testing.assert_allclose(te["prediction_entropy"], np.log(13), rtol=1e-5)


@pytest.fixture
def datasets(tmp_path):
    """A synthetic data root in the checked-in layouts (synthetic.py)."""
    root = tmp_path / "data"
    write_segmentation_dataset(root, 10, seed=0, size=64)
    write_squares_dataset(root, 2, 1, seed=0)
    return root


def test_loaders_and_tables_match_jax(datasets) -> None:
    """Both packages load the same arrays, ids and splits from the same
    files, register the same tables, and draw the same batches."""
    jseg, tseg = jdata.load_board_extraction(datasets), data_lib.load_board_extraction(datasets)
    for f in ("train_images", "train_masks", "val_images", "val_masks"):
        np.testing.assert_array_equal(getattr(jseg, f), getattr(tseg, f))
    assert (jseg.train_ids, jseg.val_ids) == (tseg.train_ids, tseg.val_ids) and tseg.train_images.shape[1:] == (256, 256, 3)
    jsq, tsq = jdata.load_squares(datasets), data_lib.load_squares(datasets)
    np.testing.assert_array_equal(jsq.train_images, tsq.train_images)
    np.testing.assert_array_equal(jsq.train_labels, tsq.train_labels)
    assert tsq.class_names == ["B", "K", "N", "P", "Q", "R", "_b", "_k", "_n", "_p", "_q", "_r", "f"]
    assert tsq.train_labels.tolist() == [i for i in range(13) for _ in range(2)]
    for kw in ({}, {"rng": True}, {"rng": True, "weights": np.arange(1.0, 11.0)}):
        args = {k: (np.random.default_rng(3) if k == "rng" else v) for k, v in kw.items()}
        argt = {k: (np.random.default_rng(3) if k == "rng" else v) for k, v in kw.items()}
        assert [b.tolist() for b in jdata.batches(10, 4, drop_last=True, **args)] == [
            b.tolist() for b in data_lib.batches(10, 4, drop_last=True, **argt)]
    idx, real = data_lib.pad_indices(np.array([1, 2]), 4)
    assert idx.tolist() == [1, 2, 2, 2] and real == 2

    t = ttables.get_or_create_board_extraction_tables(data_root=datasets)
    j = jtables.get_or_create_board_extraction_tables(data_root=datasets)  # loads the port's tables
    assert list(t["val"]["example_id"]) == list(j["val"]["example_id"]) == tseg.val_ids
    c = ttables.get_or_create_classification_tables(data_root=datasets)
    assert len(c["train"]) == 26 and len(c["val"]) == 13
    ids = list(c["train"]["example_id"][:3])
    assert ttables.sample_weights_for_ids(c["train"], ids) is None
    w = np.ones(len(c["train"]))
    w[0] = 5.0
    c["train"].with_column("sample_weight", w)
    got = ttables.sample_weights_for_ids(c["train"], ids)
    assert got is not None and got[0] == 5.0 and got[1] == 1.0


def test_load_image_mask_dir_and_squares_dir(tmp_path) -> None:
    import cv2

    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    rng = np.random.default_rng(0)
    for i, side in enumerate([256, 128]):  # one native, one needing resize
        mask = np.zeros((side, side), np.uint8)
        mask[side // 4 : 3 * side // 4, side // 4 : 3 * side // 4] = 255
        cv2.imwrite(str(tmp_path / "images" / f"b{i}.png"), rng.integers(0, 255, (side, side, 3), np.uint8))
        cv2.imwrite(str(tmp_path / "masks" / f"b{i}.png"), mask)
    images, masks, ids = data_lib.load_image_mask_dir(tmp_path)
    jimages, jmasks, jids = jdata.load_image_mask_dir(tmp_path)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(masks, jmasks)
    assert ids == jids == ["b0", "b1"] and masks.shape == (2, 256, 256)
    with pytest.raises(ValueError):
        data_lib.load_image_mask_dir(tmp_path / "images")

    sq = tmp_path / "squares"
    for d, n in [("f", 2), ("_b", 1)]:
        (sq / d).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(sq / d / f"s{i}.png"), rng.integers(0, 255, (64, 64), np.uint8))
    images, labels, ids = data_lib.load_squares_dir(sq, ["B", "_b", "f"])
    assert images.shape == (3, 64, 64) and labels.tolist() == [1, 2, 2]
    assert ids == ["_b/s0.png", "f/s0.png", "f/s1.png"]
    (sq / "zz").mkdir()
    cv2.imwrite(str(sq / "zz" / "s.png"), np.zeros((64, 64), np.uint8))
    with pytest.raises(ValueError):
        data_lib.load_squares_dir(sq, ["B", "_b", "f"])
