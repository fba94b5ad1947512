#!/usr/bin/env bash
# YOLO-cls slot of the PyTorch port (counterpart of
# scripts/bin/train_yolo_classifier.sh).
set -e
exec python -m chessvision_tpu_torch.train.train_classifier --model-id yolo \
  --epochs 30 --batch-size 256 --learning-rate 1e-3 --lr-step-size 10 "$@"
