"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the entry point the mix drives
(``entries/<entry>.py``), the comparison that decides ``correct``
(``checks/<check>.py``) and its limits (``limits/<cell>.json``), the
reader of each end-to-end metric (``end_to_end/<metric>.py``) and of each
per-layer metric (``layer_metrics/<metric>.py``); the configuration's
models are found by their model ids, each architecture's reference in
``reference/archs/<model_id>.py`` (``reference.models.arch``).  A later
cell, configuration, architecture, mix, entry, check or metric is a new
file and a new entry, never an edit here."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    name: str
    config: dict[str, Any]
    traffic: dict[str, Any]
    limits: dict[str, float]
    chips: int
    end_to_end: list[dict[str, Any]]  # this cell's end-to-end metrics
    per_layer: list[dict[str, Any]]  # this cell's per-layer metrics


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names."""
    bench = _json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file.name}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in moved]
    return Cell(
        name=name,
        config=config,
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        chips=int(w["chips"]),
        end_to_end=e2e,
        per_layer=layer,
    )


@functools.lru_cache(maxsize=None)
def _module(folder: str, name: str) -> ModuleType:
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """The module ``layer_metrics/<metric>.py``, or, where there is none,
    the one of the name without its last ``.<suffix>`` (one reader serves
    ``mfu.batch`` and ``mfu.photo``, which move different end-to-end
    metrics); its ``read(ctx)`` returns the metric's value, or None where
    the run has nothing to read."""
    if not (HERE / "layer_metrics" / f"{metric}.py").exists() and "." in metric:
        metric = metric.rsplit(".", 1)[0]
    return _module("layer_metrics", metric)


def entry(name: str) -> type:
    """The class ``Entry`` of ``entries/<name>.py``: the entry point of the
    port that a traffic mix drives."""
    return _module("entries", name).Entry


def check(name: str) -> ModuleType:
    """The module ``checks/<name>.py``: its ``Judge(reference)`` compares
    what the timed path returned with the plain reference, and its
    ``control_outputs(control, frames)`` puts the control in the
    program's place."""
    return _module("checks", name)


def end_to_end(metric: str) -> ModuleType:
    """The module ``end_to_end/<metric>.py``; its ``read(window)`` returns
    the metric's value over a measured window."""
    return _module("end_to_end", metric)
