#!/usr/bin/env bash
# Canonical segmentation training of the PyTorch port on one GPU
# (counterpart of scripts/bin/train_board_extractor.sh, same defaults).
set -e
exec python -m chessvision_tpu_torch.train.train_unet \
  --epochs 30 --batch-size 32 --learning-rate 3e-5 \
  --use-sample-weights --threshold 0.5 --patience 8 "$@"
