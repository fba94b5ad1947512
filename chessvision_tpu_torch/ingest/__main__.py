"""``python -m chessvision_tpu_torch.ingest``: the ingestion CLI."""

from chessvision_tpu_torch.ingest.pipeline import main

raise SystemExit(main())
