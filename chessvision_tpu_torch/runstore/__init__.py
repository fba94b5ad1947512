"""Local run/metrics/table store: the port's copy of
``chessvision_tpu/runstore``, with the same on-disk layout and the same
``CVTPU_STORE_ROOT``, so either package reads the other's runs and tables.

Layout on disk:
    <root>/projects/<project>/datasets/<dataset>/<table_name>/
        data.parquet      — columns
        schema.json       — column kinds + lineage (parents, op)
    <root>/projects/<project>/runs/<run_name>/
        params.json       — parameters + status
        scalars.jsonl     — one JSON object per ``Run.log`` call
        metrics/<name>.parquet — per-sample metrics tables
        bulk/             — checkpoints and other artifacts
"""

from chessvision_tpu_torch.runstore.runs import NullRun, Run, init, list_runs
from chessvision_tpu_torch.runstore.tables import Table

__all__ = ["NullRun", "Run", "Table", "init", "list_runs"]
