#!/usr/bin/env bash
# Data-parallel training launcher of the PyTorch port (counterpart of
# scripts/bin/train_distributed.sh): one process per GPU, started by
# torchrun, which exports MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
# LOCAL_RANK; the trainer joins that process group over NCCL
# (chessvision_tpu_torch/parallel/mesh.py) and computes on cuda:LOCAL_RANK.
#
# On one machine with 4 GPUs:
#
#   NPROC=4 scripts/bin/torch_train_distributed.sh --epochs 30 --batch-size 256
#
# On several machines, run the same command on each with torchrun's
# rendezvous flags in TORCHRUN_ARGS, e.g.
# TORCHRUN_ARGS="--nnodes 2 --node-rank 0 --master-addr HOST --master-port 29500".
#
# For a local 2-process CPU rehearsal over gloo (the path the CPU tests
# exercise with explicit --coordinator/--num-processes/--process-id flags):
#
#   NPROC=2 scripts/bin/torch_train_distributed.sh --device cpu --epochs 1
#
# Each process makes cuda:LOCAL_RANK its current device before it joins
# the group and leaves the group when it ends.  NCCL refuses two ranks on
# one card (the mesh raises, naming both): with fewer GPUs than processes
# run gloo, through host memory (Mesh.comm_device).  Every process loads
# the same seeded data order, uploads and augments only its rows of each
# batch; rank 0 owns the run directory, checkpoints, promotion and
# evaluation.  A trainer started without torchrun on a machine with
# several GPUs logs that it uses one and how to use them all.
set -e
exec torchrun --nproc-per-node "${NPROC:-1}" ${TORCHRUN_ARGS} \
  -m chessvision_tpu_torch.train.train_unet \
  --epochs 30 --batch-size 32 --learning-rate 3e-5 \
  --use-sample-weights --threshold 0.5 --patience 8 "$@"
