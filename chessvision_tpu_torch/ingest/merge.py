"""Dataset merge tools, the counterpart of ``chessvision_tpu/ingest/
merge.py``: join a new raw batch into the latest test-set revision, and
filter-then-join into the training set, as runstore Table lineage ops.
"""

from __future__ import annotations

import logging

import numpy as np

from chessvision_tpu_torch.runstore import Table

logger = logging.getLogger(__name__)


def merge_new_test_batch(
    batch_table: Table,
    *,
    test_project: str = "chessvision-testing",
    test_dataset: str = "test",
    test_table_name: str = "initial",
    merged_name: str | None = None,
) -> Table:
    """Join a new raw batch into the test-set lineage (the reference's
    Table.join_tables on the latest revision, merge_new_test.py:35-38)."""
    base = Table.load(test_project, test_dataset, test_table_name)
    merged = base.join(batch_table, merged_name or f"{test_table_name}+{batch_table.name}")
    merged.save()
    logger.info("Merged %d + %d rows -> %s", len(base), len(batch_table), merged.url)
    return merged


def merge_filtered_into_training(
    batch_table: Table,
    *,
    filter_column: str = "extraction_success",
    train_project: str = "chessvision-segmentation",
    train_dataset: str = "board_extraction",
    train_table_name: str = "initial",
    merged_name: str | None = None,
) -> Table:
    """Filter the batch by a bool column then join into the training table
    (FilteredTable + BoolFilterCriterion + join_tables,
    run_merge_pipeline.py:13-33)."""
    mask = np.asarray(batch_table[filter_column]).astype(bool)
    filtered = batch_table.filter(mask, f"{batch_table.name}-filtered")
    base = Table.load(train_project, train_dataset, train_table_name)
    merged = base.join(filtered, merged_name or f"{train_table_name}+{filtered.name}")
    merged.save()
    logger.info(
        "Filtered %d -> %d rows, merged into %s", len(batch_table), len(filtered), merged.url
    )
    return merged
