#!/usr/bin/env bash
# Grid sweep of the PyTorch port (counterpart of
# scripts/bin/train_board_extractor_sweep.sh: lr grid x thresholds), via
# the Python sweep runner.
set -e
exec python -m chessvision_tpu_torch.train.sweep --target unet \
  --learning-rates 1e-5 3e-5 1e-4 3e-4 --thresholds 0.3 0.5 0.7 "$@"
