"""The port's sweep runner, YOLO-seg exporter and runstore viewer against
the JAX package's, on the CPU.

- ``run_sweep`` over stubbed trainers (both packages) makes the same
  calls and the same runs; ``collect_sweep_data`` reads the same rows from
  one store; the port's cv2 plot is written;
- ``export_yolo_segmentation_dataset`` writes byte-identical images and
  labels and the same ``dataset.yaml`` (its ``path:`` line names each
  output directory) on the same data;
- the viewer's index and run pages are byte-identical over one store, and
  its ``/file`` route serves inside the store and refuses outside it.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from chessvision_tpu import runstore as jrunstore
from chessvision_tpu.runstore import view as jview
from chessvision_tpu.train import sweep as jsweep
from chessvision_tpu.train import yolo_export as jexport
from chessvision_tpu_torch import runstore as trunstore
from chessvision_tpu_torch.runstore import view as tview
from chessvision_tpu_torch.train import sweep as tsweep
from chessvision_tpu_torch.train import yolo_export as texport


@pytest.fixture(autouse=True)
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    return tmp_path / "store"


@pytest.mark.parametrize("target", ["unet", "classifier"])
def test_run_sweep_matches_jax_on_stub_trainers(monkeypatch, target) -> None:
    calls: dict[str, list[dict]] = {"jax": [], "port": []}

    def stub(pkg, runstore_mod):
        def train_model(**kwargs):
            calls[pkg].append(kwargs)
            run = runstore_mod.init(f"{pkg}-{target}", kwargs["run_name"], parameters={
                "learning_rate": kwargs["learning_rate"], "threshold": kwargs.get("threshold"),
                "use_sample_weights": kwargs["use_sample_weights"], "best_val_score": 0.5 + kwargs["learning_rate"],
            })
            return run, "checkpoint.npz"
        return train_model

    module = "train_unet" if target == "unet" else "train_classifier"
    import importlib

    monkeypatch.setattr(importlib.import_module(f"chessvision_tpu.train.{module}"), "train_model", stub("jax", jrunstore))
    monkeypatch.setattr(importlib.import_module(f"chessvision_tpu_torch.train.{module}"), "train_model", stub("port", trunstore))
    grid = {"learning_rates": (1e-5, 1e-4), "thresholds": (0.3, 0.7), "sample_weights": (False, True), "epochs": 2, "sweep_id": 3}
    jruns = jsweep.run_sweep(target=target, **grid)
    truns = tsweep.run_sweep(target=target, **grid)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == (8 if target == "unet" else 4)
    assert [r.name for r in truns] == [r.name for r in jruns]
    assert all(r.parameters["sweep_id"] == 3 for r in truns)
    # each package reads the other's sweep rows from the store alike
    for project in (f"jax-{target}", f"port-{target}"):
        assert tsweep.collect_sweep_data(project, 3) == jsweep.collect_sweep_data(project, 3)
    with pytest.raises(ValueError):
        tsweep.run_sweep(target="nope")


def test_sweep_collect_and_plot(tmp_path) -> None:
    for i, (lr, score) in enumerate([(1e-5, 0.91), (3e-5, 0.95), (1e-4, 0.93)]):
        trunstore.init("sweep-proj", f"s-{i}", parameters={
            "learning_rate": lr, "threshold": 0.5, "use_sample_weights": False, "best_val_score": score, "sweep_id": 7,
        })
    rows = tsweep.collect_sweep_data("sweep-proj", sweep_id=7)
    assert rows == jsweep.collect_sweep_data("sweep-proj", sweep_id=7) and len(rows) == 3
    out = tsweep.plot_sweep("sweep-proj", 7, out_path=str(tmp_path / "sweep.png"))
    import cv2

    img = cv2.imread(out)
    assert img is not None and img.shape == (600, 1200, 3) and (img != 255).any()
    with pytest.raises(ValueError):
        tsweep.plot_sweep("sweep-proj", 8)


def _export_data():
    rng = np.random.default_rng(0)
    masks = np.zeros((4, 256, 256), np.float32)
    for i, (y0, x0, y1, x1) in enumerate([(40, 40, 200, 220), (10, 90, 120, 240), (60, 5, 250, 100)]):
        masks[i, y0:y1, x0:x1] = 1.0
    # a tilted quadrilateral and an empty mask
    import cv2

    tilted = np.zeros((256, 256), np.uint8)
    cv2.fillConvexPoly(tilted, np.array([[30, 20], [220, 40], [230, 230], [20, 210]], np.int32), 255)
    masks[3] = tilted / 255.0
    return SimpleNamespace(
        train_images=rng.integers(0, 256, (3, 256, 256, 3), np.uint8),
        train_masks=np.concatenate([masks[:1], masks[3:], np.zeros((1, 256, 256), np.float32)]),
        train_ids=["a.JPG", "d.png", "empty.png"],
        val_images=rng.integers(0, 256, (2, 256, 256, 3), np.uint8),
        val_masks=masks[1:3],
        val_ids=["b.JPG", "c.JPG"],
    )


def test_yolo_export_matches_jax(tmp_path) -> None:
    data = _export_data()
    got = texport.export_yolo_segmentation_dataset(tmp_path / "port", data=data)
    want = jexport.export_yolo_segmentation_dataset(tmp_path / "jax", data=data)
    assert got == want == {"train": 2, "val": 2}
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        a, b = (tmp_path / "port" / rel).read_bytes(), (tmp_path / "jax" / rel).read_bytes()
        if rel.name == "dataset.yaml":
            a = a.replace(str((tmp_path / "port").resolve()).encode(), b"ROOT")
            b = b.replace(str((tmp_path / "jax").resolve()).encode(), b"ROOT")
        assert a == b, rel
    for m in data.train_masks:
        mask = (m * 255).astype(np.uint8)
        a, b = texport.mask_to_polygon(mask), jexport.mask_to_polygon(mask)
        assert (a is None and b is None) or np.array_equal(a, b)
    pts = np.random.default_rng(1).integers(0, 50, (40, 2)).astype(np.float32)
    assert np.array_equal(texport._convex_hull(pts), jexport._convex_hull(pts))


def _fill_store(store: Path) -> Path:
    run = trunstore.init("viewproj", "run-a", {"lr": 1e-3, "nested": {"a": 1}})
    for i in range(5):
        run.log({"epoch": i, "val_dice": 0.9 + 0.01 * i})
    art = run.bulk_data_url / "m.png"
    art.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(100))
    run.write_metrics_table(
        "val_epoch1",
        {
            "example_id": np.asarray(["a", "b"], object),
            "loss": np.asarray([0.1, 0.2], np.float32),
            "mask_image": np.asarray([str(art), ""], object),
            "embedding_2d": np.asarray([[0.0, 1.0], [1.0, 0.0]], np.float32),
        },
    )
    run.set_status_completed()
    jrunstore.init("viewproj", "run-b", {"best_val_score": 0.5})
    return art


def test_view_pages_equal_jax_byte_for_byte(store) -> None:
    assert tview.index_page() == jview.index_page()  # no projects yet
    _fill_store(store)
    assert tview.index_page() == jview.index_page()
    for name in ("run-a", "run-b"):
        assert tview.run_page("viewproj", name) == jview.run_page("viewproj", name)


def test_view_server_serves_and_jails_files(store) -> None:
    art = _fill_store(store)
    server = ThreadingHTTPServer(("127.0.0.1", 0), tview.make_handler())
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, b""

    try:
        status, body = get("/run?project=viewproj&name=run-a")
        assert status == 200 and body == jview.run_page("viewproj", "run-a")
        assert b"<polyline" in body and b"img class='thumb'" in body and b"<circle" in body
        assert get("/file?p=" + str(art)) == (200, art.read_bytes())
        for outside in ("/etc/passwd", str(store / ".." / "x.png")):
            assert get("/file?p=" + outside)[0] == 403
            assert tview._serve_file(outside)[0] == jview._serve_file(outside)[0] == 403
        assert get("/nope")[0] == 404
    finally:
        server.shutdown()
