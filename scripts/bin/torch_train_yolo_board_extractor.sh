#!/usr/bin/env bash
# YOLO-seg slot of the PyTorch port (counterpart of
# scripts/bin/train_yolo_board_extractor.sh).
set -e
exec python -m chessvision_tpu_torch.train.train_unet --model-id yolo --optimizer adam \
  --epochs 30 --batch-size 32 --learning-rate 1e-3 "$@"
