#!/usr/bin/env bash
# The PyTorch port's inference server on the GPU (counterpart of
# scripts/bin/serve.sh): PORT (default 7777), warmed before it listens.
set -e
exec python -m chessvision_tpu_torch.serve.server --port "${PORT:-7777}" --warmup "$@"
