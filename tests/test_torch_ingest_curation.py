"""The port's ingestion pipeline, merge tools and curation utilities against
the JAX package's, on the CPU.

- the four quality scores on the same masks and quads: equal to 1e-6
  (``mask_completeness`` floods with the port's
  ``ops/quad.connected_component``);
- ``run_pipeline(input_folder=…)`` on stub engines (the stubs of
  tests/test_torch_engine.py, 2 uploads of 512²): the same table and an
  enrichment table with equal ids, success flags and FENs and scores to
  1e-6; the CLI passes its flags and device and writes its table and run;
- the merge tools, ``scan_image_issues``, ``attach_issue_scan``,
  ``create_subset`` and ``ingest_edited_masks`` give the JAX package's
  columns and lineage on the same inputs.
"""

from __future__ import annotations

import numpy as np
import pytest

from chessvision_tpu import curation as jcur
from chessvision_tpu import ingest as jingest
from chessvision_tpu.engine import Engine as JaxEngine
from chessvision_tpu.ingest import merge as jmerge
from chessvision_tpu.runstore import Table as JTable
from chessvision_tpu_torch import curation as tcur
from chessvision_tpu_torch import ingest as tingest
from chessvision_tpu_torch.engine import Engine
from chessvision_tpu_torch.ingest import merge as tmerge
from chessvision_tpu_torch.runstore import Table as TTable
from tests.test_torch_engine import STUB_QUAD, JaxStub, StubClassifier, StubExtractor, _quad_logits, _start_position_logits


@pytest.fixture(autouse=True)
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("CVTPU_STORE_ROOT", str(tmp_path / "store"))
    return tmp_path / "store"


def _masks() -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    solid = np.zeros((256, 256), np.float32)
    solid[50:200, 40:210] = 0.97
    holey = solid.copy()
    holey[100:150, 100:150] = 0.02
    specks = solid * 0.9
    specks[5:9, 5:9] = 0.99  # a speck with a higher score than the board
    ring = np.zeros((256, 256), np.float32)
    ring[30:220, 30:220] = 0.8
    ring[60:190, 60:220] = 0.1  # a C shape
    soft = rng.random((256, 256)).astype(np.float32)
    return [solid, holey, specks, ring, soft, np.zeros((256, 256), np.float32)]


@pytest.mark.parametrize("i", range(6))
def test_quality_scores_match_jax(i) -> None:
    m = _masks()[i]
    for name in ("probability_distribution", "mask_completeness", "probability_confidence"):
        got, want = getattr(tingest, name)(m), getattr(jingest, name)(m)
        assert abs(got - want) <= 1e-6, (name, got, want)
    quad = np.array([[10, 12], [240, 20], [230, 250], [5, 230]], np.float32) + i
    assert abs(tingest.quadrangle_regularity(quad) - jingest.quadrangle_regularity(quad)) <= 1e-6
    assert tingest.quadrangle_regularity(None) == jingest.quadrangle_regularity(None) == 0.0


def _uploads(tmp_path, n: int = 2):
    import cv2

    raw = tmp_path / "raw"
    raw.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        cv2.imwrite(str(raw / f"up{i}.jpg"), rng.integers(0, 256, (512, 512, 3), np.uint8))
    (raw / "notes.txt").write_text("not an image")
    return raw


def test_run_pipeline_on_stub_engines_matches_jax(tmp_path) -> None:
    raw = _uploads(tmp_path)
    seg, cls = _quad_logits(STUB_QUAD), _start_position_logits()

    class PortCV:
        engine = Engine(StubExtractor(seg), StubClassifier(cls), device="cpu")

    class JaxCV:
        engine = JaxEngine(JaxStub(seg, "extractor"), {}, JaxStub(cls, "classifier"), {})

    ttable, trun = tingest.run_pipeline(input_folder=raw, cv_model=PortCV(), table_name="b1", project="port-raw")
    jtable, jrun = jingest.run_pipeline(input_folder=raw, cv_model=JaxCV(), table_name="b1", project="jax-raw")
    assert len(ttable) == len(jtable) == 2
    for col in ("path", "filename"):
        assert list(ttable[col]) == list(jtable[col])
    got, want = trun.read_metrics_table("enrichment"), jrun.read_metrics_table("enrichment")
    assert got.keys() == want.keys()
    for k in ("example_id", "extraction_success", "fen"):
        assert list(got[k]) == list(want[k]), k
    assert list(got["extraction_success"]) == [1, 1] and all(f.count("/") == 7 for f in got["fen"])
    for k in ("probability_distribution", "mask_completeness", "quadrangle_regularity", "probability_confidence"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert trun.parameters["status"] == "completed"
    with pytest.raises(ValueError):
        tingest.run_pipeline()


def test_ingest_cli_builds_chessvision_on_the_device_and_writes_its_run(tmp_path, store, capsys, monkeypatch) -> None:
    """The CLI's flags reach ``run_pipeline``; the engine it builds (stubbed
    here: the committed models cost seconds a board on the CPU) is asked
    for the device the command line names."""
    from chessvision_tpu_torch import core
    from chessvision_tpu_torch.ingest.pipeline import main

    seen = {}

    class StubCV:
        def __init__(self, **kwargs) -> None:
            seen.update(kwargs)
            self.engine = Engine(StubExtractor(_quad_logits(STUB_QUAD)), StubClassifier(_start_position_logits()), device="cpu")

    monkeypatch.setattr(core, "ChessVision", StubCV)
    raw = _uploads(tmp_path, 1)
    assert main(["--input-folder", str(raw), "--device", "cpu", "--table-name", "cli", "--project", "cli-raw"]) == 0
    assert seen == {"lazy_load": False, "device": "cpu"}
    out = capsys.readouterr().out
    assert "table:" in out and "run:" in out
    assert len(TTable.load("cli-raw", "raw", "cli")) == 1
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])


def test_merge_tools_match_jax() -> None:
    for tcls, proj in ((TTable, "p"), (JTable, "j")):
        tcls(f"{proj}-test", "test", "initial", {"x": np.arange(3)}).save()
        tcls(f"{proj}-seg", "board_extraction", "initial", {"x": np.arange(2)}).save()
    batch = {"x": np.arange(10, 14), "extraction_success": np.asarray([1, 0, 1, 1])}
    tb, jb = TTable("p-raw", "raw", "b", dict(batch)).save(), JTable("j-raw", "raw", "b", dict(batch)).save()
    got = tmerge.merge_new_test_batch(tb, test_project="p-test")
    want = jmerge.merge_new_test_batch(jb, test_project="j-test")
    assert got.name == want.name and list(got["x"]) == list(want["x"])
    got = tmerge.merge_filtered_into_training(tb, train_project="p-seg")
    want = jmerge.merge_filtered_into_training(jb, train_project="j-seg")
    assert got.name == want.name and list(got["x"]) == list(want["x"]) == [0, 1, 10, 12, 13]


def _issue_images(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    normal = rng.integers(0, 256, (64, 64), np.uint8)
    images = {
        "normal": normal, "dark": (normal * 0.1).astype(np.uint8),
        "bright": np.clip(normal * 0.2 + 215, 0, 255).astype(np.uint8),
        "flat": np.full((64, 64), 128, np.uint8), "blurry": cv2.GaussianBlur(normal, (15, 15), 8), "dup": normal.copy(),
    }
    paths = []
    for name, img in images.items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), img)
        paths.append(tmp_path / f"{name}.png")
    return paths + [tmp_path / "missing.png"]


def test_issue_scan_and_subset_match_jax(tmp_path) -> None:
    paths = _issue_images(tmp_path)
    got, want = tcur.scan_image_issues(paths), jcur.scan_image_issues(paths)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    assert got["is_near_duplicate"][5] and not got["is_near_duplicate"][0] and not got["readable"][6]
    cols = {"path": np.asarray([str(p) for p in paths], object)}
    tt, jt = TTable("proj", "ds", "raw", dict(cols)), JTable("jproj", "ds", "raw", dict(cols))
    tcur.attach_issue_scan(tt)
    jcur.attach_issue_scan(jt)
    tsub, jsub = tcur.create_subset(tt, "clean"), jcur.create_subset(jt, "clean")
    assert list(tsub["path"]) == list(jsub["path"]) and len(tsub) == 1
    assert tsub.lineage["parents"] == [tt.url]
    tsub2 = tcur.create_subset(tt, "no-dark", drop_issues=False, predicate=lambda r: not r["is_dark"])
    jsub2 = jcur.create_subset(jt, "no-dark", drop_issues=False, predicate=lambda r: not r["is_dark"])
    assert list(tsub2["path"]) == list(jsub2["path"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ingest_edited_masks_matches_jax(tmp_path, dtype) -> None:
    import cv2

    edit_dir = tmp_path / "edits"
    edit_dir.mkdir()
    edited = np.zeros((32, 32), np.uint8)
    edited[8:24, 8:24] = 255
    cv2.imwrite(str(edit_dir / "b.png"), edited)
    cv2.imwrite(str(edit_dir / "c.png"), cv2.resize(edited, (64, 64)))  # resized on ingest
    cols = {"example_id": np.asarray(["a", "img:b", "dir/c"], object), "mask": np.zeros((3, 32, 32), dtype)}
    got = tcur.ingest_edited_masks(TTable("proj", "ds", "seg", dict(cols)), edit_dir, "seg-edited")
    want = jcur.ingest_edited_masks(JTable("jproj", "ds", "seg", dict(cols)), edit_dir, "seg-edited")
    assert got.lineage["edited_masks"] == want.lineage["edited_masks"] == 2
    assert np.array_equal(np.asarray(got["mask"]), np.asarray(want["mask"]))
