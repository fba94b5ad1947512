#!/usr/bin/env bash
# Full evaluation suite of the PyTorch port on the GPU (counterpart of
# scripts/bin/evaluate.sh).  --test-root DIR picks the test batches,
# --device cpu runs without a GPU.
set -e
exec python -m chessvision_tpu_torch.eval.evaluate --include-metrics-table "$@"
