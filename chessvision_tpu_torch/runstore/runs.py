"""Run lifecycle: parameters, scalar logs, per-sample metrics, artifacts
(the port's copy of ``chessvision_tpu/runstore/runs.py``, same files).

Mirrors the reference's 3LC run usage: ``tlc.init(project, run_name,
parameters)`` (train_unet.py:154-159), ``tlc.log({...})`` scalars
(train_unet.py:336-342), ``run.set_parameters`` (train_unet.py:409-418),
``run.bulk_data_url`` checkpoint placement (train_unet.py:161-163),
per-sample metrics tables (tlc.collect_metrics), embeddings reduction
(run.reduce_embeddings_by_foreign_table_url — pacmap replaced with PCA,
pacmap being unavailable and the capability being "2-D map for the UI"),
and ``set_status_completed`` (evaluate.py:369).
"""

from __future__ import annotations

import datetime
import json
import os

from typing import Any

import numpy as np

from chessvision_tpu_torch.runstore.tables import Table, store_root


class Run:
    def __init__(self, project_name: str, run_name: str, description: str | None = None) -> None:
        self.project = project_name
        self.name = run_name
        self.dir = store_root() / "projects" / project_name / "runs" / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "metrics").mkdir(exist_ok=True)
        self.bulk_data_url = self.dir / "bulk"
        self.bulk_data_url.mkdir(exist_ok=True)
        self._params_path = self.dir / "params.json"
        self._scalars_path = self.dir / "scalars.jsonl"
        if not self._params_path.exists():
            self._write_params({"status": "running", "description": description or "",
                                "created": datetime.datetime.now().isoformat()})

    # -- params ------------------------------------------------------------------

    def _read_params(self) -> dict[str, Any]:
        if self._params_path.exists():
            return json.loads(self._params_path.read_text())
        return {}

    def _write_params(self, params: dict[str, Any]) -> None:
        self._params_path.write_text(json.dumps(params, indent=2, default=str))

    def set_parameters(self, parameters: dict[str, Any]) -> None:
        p = self._read_params()
        p.update(parameters)
        self._write_params(p)

    @property
    def parameters(self) -> dict[str, Any]:
        return self._read_params()

    def set_status_completed(self) -> None:
        self.set_parameters({"status": "completed"})

    # -- scalar logging -------------------------------------------------------------

    def log(self, values: dict[str, Any]) -> None:
        with self._scalars_path.open("a") as f:
            f.write(json.dumps({k: _tofloat(v) for k, v in values.items()}) + "\n")

    def scalars(self) -> list[dict[str, Any]]:
        if not self._scalars_path.exists():
            return []
        return [json.loads(line) for line in self._scalars_path.read_text().splitlines() if line]

    # -- per-sample metrics ------------------------------------------------------------

    def write_metrics_table(self, name: str, columns: dict[str, np.ndarray]) -> Table:
        """Persist a per-sample metrics table under this run."""
        t = Table(self.project, f"run-{self.name}-metrics", name, columns)
        import pyarrow as pa
        import pyarrow.parquet as pq

        arrays = {}
        kinds = {}
        for k, v in columns.items():
            v = np.asarray(v)
            if v.dtype == object or v.dtype.kind in "US":
                arrays[k] = pa.array([str(x) for x in v])
                kinds[k] = "str"
            elif v.ndim > 1:
                arrays[k] = pa.array(v.reshape(len(v), -1).tolist())
                kinds[k] = f"array:{','.join(map(str, v.shape[1:]))}:{v.dtype.str}"
            else:
                arrays[k] = pa.array(v)
                kinds[k] = str(v.dtype)
        pq.write_table(pa.table(arrays), self.dir / "metrics" / f"{name}.parquet")
        (self.dir / "metrics" / f"{name}.schema.json").write_text(json.dumps({"kinds": kinds}))
        return t

    def read_metrics_table(self, name: str) -> dict[str, np.ndarray]:
        import pyarrow.parquet as pq

        path = self.dir / "metrics" / f"{name}.parquet"
        schema = json.loads((self.dir / "metrics" / f"{name}.schema.json").read_text())
        tbl = pq.read_table(path)
        out: dict[str, np.ndarray] = {}
        for k in tbl.column_names:
            kind = schema["kinds"].get(k, "")
            col = tbl.column(k).to_pylist()
            if kind.startswith("array:"):
                _, shape_s, dt = kind.split(":")
                shape = tuple(int(x) for x in shape_s.split(","))
                out[k] = np.asarray(col, dtype=np.dtype(dt)).reshape(len(col), *shape)
            elif kind == "str":
                out[k] = np.asarray(col, object)
            else:
                out[k] = np.asarray(col)
        return out

    def list_metrics_tables(self) -> list[str]:
        return sorted(p.stem for p in (self.dir / "metrics").glob("*.parquet"))

    # -- embeddings reduction -------------------------------------------------------------

    def reduce_embeddings(self, metrics_name: str, column: str = "embedding", n_components: int = 2) -> None:
        """Reduce a high-dim embedding column to n-D via PCA and store it as
        ``<column>_2d`` (capability analogue of pacmap reduction,
        train_unet.py:402-407)."""
        cols = self.read_metrics_table(metrics_name)
        emb = np.asarray(cols[column], np.float64)
        emb = emb - emb.mean(axis=0, keepdims=True)
        # PCA via SVD
        _, _, vt = np.linalg.svd(emb, full_matrices=False)
        reduced = emb @ vt[:n_components].T
        cols[f"{column}_{n_components}d"] = reduced.astype(np.float32)
        del cols[column]
        self.write_metrics_table(metrics_name, cols)


class NullRun:
    """No-op Run for non-main processes in multi-host training: only
    process 0 owns the run directory, scalars, and artifacts; every other
    process logs into the void (their metric values are replicas of
    process 0's anyway)."""

    def __init__(self) -> None:
        import tempfile
        from pathlib import Path as _Path

        self.project = "null"
        self.name = "null"
        self.dir = _Path(tempfile.mkdtemp(prefix="cvtpu-nullrun-"))
        self.bulk_data_url = self.dir

    @property
    def parameters(self) -> dict[str, Any]:
        return {}

    def set_parameters(self, parameters: dict[str, Any]) -> None:
        pass

    def set_status_completed(self) -> None:
        pass

    def log(self, values: dict[str, Any]) -> None:
        pass

    def scalars(self) -> list[dict[str, Any]]:
        return []

    def write_metrics_table(self, name: str, columns: dict[str, Any]) -> None:
        return None

    def list_metrics_tables(self) -> list[str]:
        return []

    def reduce_embeddings(self, metrics_name: str, column: str = "embedding", n_components: int = 2) -> None:
        pass


def _tofloat(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def init(
    project_name: str,
    run_name: str | None = None,
    parameters: dict[str, Any] | None = None,
    description: str | None = None,
) -> Run:
    """Create (or resume) a run — the ``tlc.init`` analogue."""
    if run_name is None:
        run_name = datetime.datetime.now().strftime("run-%Y%m%d-%H%M%S") + f"-{os.getpid()}"
    run = Run(project_name, run_name, description)
    if parameters:
        run.set_parameters(parameters)
    return run


def list_runs(project_name: str) -> list[str]:
    d = store_root() / "projects" / project_name / "runs"
    if not d.exists():
        return []
    return sorted(p.name for p in d.iterdir() if p.is_dir())
