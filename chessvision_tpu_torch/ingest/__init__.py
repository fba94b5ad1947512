"""Raw-data ingestion and enrichment on the port's engine (counterpart of
``chessvision_tpu/ingest``)."""

from chessvision_tpu_torch.ingest.pipeline import (
    download_raw_data,
    enrich_table,
    mask_completeness,
    probability_confidence,
    probability_distribution,
    quadrangle_regularity,
    run_pipeline,
)

__all__ = [
    "download_raw_data",
    "enrich_table",
    "run_pipeline",
    "probability_distribution",
    "mask_completeness",
    "quadrangle_regularity",
    "probability_confidence",
]
