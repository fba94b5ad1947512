"""Data parallelism over ``torch.distributed``: one process per GPU, the
batch split on its first axis (counterpart of ``chessvision_tpu/parallel``)."""

from chessvision_tpu_torch.parallel.mesh import (
    Mesh,
    average_gradients,
    create_mesh,
    host_gather,
    initialize_distributed,
    make_global_batch,
    pad_to_multiple,
    process_local_batch_slice,
    replicate,
    shard_batch,
    spans_processes,
)

__all__ = [
    "Mesh",
    "average_gradients",
    "create_mesh",
    "host_gather",
    "initialize_distributed",
    "make_global_batch",
    "pad_to_multiple",
    "process_local_batch_slice",
    "replicate",
    "shard_batch",
    "spans_processes",
]
