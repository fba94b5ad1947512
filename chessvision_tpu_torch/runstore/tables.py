"""Dataset tables with lineage (the port's copy of
``chessvision_tpu/runstore/tables.py``, same files on disk).

Capabilities mirrored from the reference's 3LC usage: creation from
arrays/folders, revisions with recorded lineage, row filtering, joining
(merge_new_test.py:35-38, run_merge_pipeline.py:13-33), per-row sample
weights with a weighted sampler (train_unet.py:186-196), and stable row
ids for joining per-sample metrics.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from chessvision_tpu_torch import constants

_DEFAULT_ROOT = Path(os.getenv("CVTPU_STORE_ROOT", str(constants.REPO_ROOT / "store")))

WEIGHT_COLUMN = "sample_weight"
ID_COLUMN = "example_id"


def store_root() -> Path:
    return Path(os.getenv("CVTPU_STORE_ROOT", str(_DEFAULT_ROOT)))


def _table_dir(project: str, dataset: str, name: str) -> Path:
    return store_root() / "projects" / project / "datasets" / dataset / name


class Table:
    """A named, versioned columnar table.

    Columns are numpy arrays (numeric/bool/str) of equal length.  Every
    table has an ``example_id`` column (stable string ids) and an optional
    ``sample_weight`` column.  Lineage (parent table URLs + the producing
    op) is recorded in schema.json.
    """

    def __init__(
        self,
        project: str,
        dataset: str,
        name: str,
        columns: dict[str, np.ndarray],
        lineage: dict[str, Any] | None = None,
    ) -> None:
        lengths = {len(v) for v in columns.values()}
        assert len(lengths) == 1, f"ragged columns: { {k: len(v) for k, v in columns.items()} }"
        self.project = project
        self.dataset = dataset
        self.name = name
        if ID_COLUMN not in columns:
            columns = dict(columns)
            columns[ID_COLUMN] = np.asarray([f"{name}:{i}" for i in range(next(iter(lengths)))], object)
        self.columns = columns
        self.lineage = lineage or {"op": "create", "parents": []}

    # -- basics ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __getitem__(self, key: str) -> np.ndarray:
        return self.columns[key]

    @property
    def url(self) -> str:
        return str(_table_dir(self.project, self.dataset, self.name))

    def rows(self) -> Iterator[dict[str, Any]]:
        keys = list(self.columns)
        for i in range(len(self)):
            yield {k: self.columns[k][i] for k in keys}

    # -- persistence -----------------------------------------------------------

    def save(self) -> "Table":
        import pyarrow as pa
        import pyarrow.parquet as pq

        d = _table_dir(self.project, self.dataset, self.name)
        d.mkdir(parents=True, exist_ok=True)
        arrays: dict[str, pa.Array] = {}
        kinds: dict[str, str] = {}
        for k, v in self.columns.items():
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
        pq.write_table(pa.table(arrays), d / "data.parquet")
        (d / "schema.json").write_text(
            json.dumps({"kinds": kinds, "lineage": self.lineage, "rows": len(self)}, indent=2)
        )
        return self

    @classmethod
    def load(cls, project: str, dataset: str, name: str) -> "Table":
        import pyarrow.parquet as pq

        d = _table_dir(project, dataset, name)
        if not (d / "data.parquet").exists():
            raise FileNotFoundError(d)
        schema = json.loads((d / "schema.json").read_text())
        tbl = pq.read_table(d / "data.parquet")
        columns: dict[str, np.ndarray] = {}
        for k in tbl.column_names:
            kind = schema["kinds"].get(k, "")
            col = tbl.column(k).to_pylist()
            if kind.startswith("array:"):
                _, shape_s, dt = kind.split(":")
                shape = tuple(int(x) for x in shape_s.split(","))
                columns[k] = np.asarray(col, dtype=np.dtype(dt)).reshape(len(col), *shape)
            elif kind == "str":
                columns[k] = np.asarray(col, object)
            else:
                columns[k] = np.asarray(col)
        return cls(project, dataset, name, columns, schema.get("lineage"))

    @classmethod
    def exists(cls, project: str, dataset: str, name: str) -> bool:
        return (_table_dir(project, dataset, name) / "data.parquet").exists()

    # -- lineage ops -------------------------------------------------------------

    def _child(self, name: str, columns: dict[str, np.ndarray], op: str, **extra: Any) -> "Table":
        return Table(
            self.project,
            self.dataset,
            name,
            columns,
            {"op": op, "parents": [self.url], **extra},
        )

    def select(self, indices: Sequence[int] | np.ndarray, name: str) -> "Table":
        idx = np.asarray(indices)
        cols = {k: v[idx] for k, v in self.columns.items()}
        return self._child(name, cols, "select", indices=len(idx))

    def filter(self, predicate: Callable[[dict[str, Any]], bool] | np.ndarray, name: str) -> "Table":
        """Row filter by bool mask or per-row predicate (the reference's
        FilteredTable + BoolFilterCriterion, run_merge_pipeline.py:13-22)."""
        if callable(predicate):
            mask = np.asarray([bool(predicate(r)) for r in self.rows()])
        else:
            mask = np.asarray(predicate, bool)
        return self.select(np.nonzero(mask)[0], name)

    def split(self, val_fraction: float, seed: int, names: tuple[str, str]) -> tuple["Table", "Table"]:
        """Deterministic train/val split (create_board_extraction_tables
        90/10 seed-0 semantics)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        n_val = max(1, int(round(len(self) * val_fraction)))
        return (
            self.select(perm[n_val:], names[0]),
            self.select(perm[:n_val], names[1]),
        )

    def join(self, other: "Table", name: str) -> "Table":
        """Row-concatenate two tables with a shared column subset
        (Table.join_tables, merge_new_test.py:35-38)."""
        keys = [k for k in self.columns if k in other.columns]
        cols = {k: np.concatenate([np.asarray(self.columns[k]), np.asarray(other.columns[k])]) for k in keys}
        out = self._child(name, cols, "join")
        out.lineage["parents"].append(other.url)
        return out

    def with_column(self, key: str, values: np.ndarray, name: str | None = None) -> "Table":
        cols = dict(self.columns)
        cols[key] = np.asarray(values)
        if name is None:
            self.columns = cols
            return self
        return self._child(name, cols, "with_column", column=key)

    # -- sampling ----------------------------------------------------------------

    def sample_weights(self) -> np.ndarray:
        if WEIGHT_COLUMN in self.columns:
            return np.asarray(self.columns[WEIGHT_COLUMN], np.float64)
        return np.ones(len(self), np.float64)

    def create_sampler(self, rng: np.random.Generator) -> Callable[[int], np.ndarray]:
        """Weighted sampler with replacement (tlc sampler semantics)."""
        w = self.sample_weights()
        p = w / w.sum()

        def sample(n: int) -> np.ndarray:
            return rng.choice(len(p), size=n, replace=True, p=p)

        return sample
