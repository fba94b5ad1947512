#!/usr/bin/env bash
# Piece-classifier training of the PyTorch port on one GPU (counterpart of
# scripts/bin/train_classifier.sh, same defaults).
set -e
exec python -m chessvision_tpu_torch.train.train_classifier \
  --epochs 30 --batch-size 256 --learning-rate 1e-3 --lr-step-size 10 "$@"
