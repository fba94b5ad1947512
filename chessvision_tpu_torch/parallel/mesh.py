"""The data-parallel layer over ``torch.distributed``.

Counterpart of ``chessvision_tpu/parallel/mesh.py``.  The JAX package
shards one program over a device mesh and XLA inserts the collectives;
here the PyTorch idiom is one process per GPU: a ``Mesh`` names the
process group, this process's rank in it and its device.  Parameters are
replicated (every rank holds the same copy), batches split on their first
axis, and the collectives are explicit: the gradient average and the
BatchNorm statistics in training (``train/steps.py``,
``models/layers.BatchNorm2d``), ``host_gather`` of the outputs in
inference (``engine.Engine(mesh=…)``).

Backends: NCCL for CUDA devices, gloo for the CPU.  NCCL refuses two
ranks on one device, so ranks that share a card run gloo; gloo's
collectives then go through host memory (``Mesh.comm_device``).  A mesh
over NCCL whose ranks share a card raises (``create_mesh``).

Each process computes on ``cuda:LOCAL_RANK`` and makes it the current
device before it joins the group (``initialize_distributed``,
``create_mesh``): calls that take no device (a synchronize, pinned host
buffers, NCCL's barrier) then act on the process's own card, not card 0.
``shutdown_distributed`` leaves the group.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "TPU_WORKER_HOSTNAMES",
    "MEGASCALE_COORDINATOR_ADDRESS",
)


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the ``size`` ranks of the default process
    group, this process's ``rank`` and the ``device`` it computes on."""

    size: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return dist.get_backend() if dist.is_initialized() else None

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors must lie: the GPU under NCCL, host
        memory under gloo (and for a mesh without a process group)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor on ``t``'s
        device); ``t`` itself for one rank without a process group."""
        if self.backend is None:
            return t
        buf = t.detach().to(self.comm_device, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on all), concatenated on axis 0,
        on every rank."""
        if self.backend is None:
            return t
        src = t.detach().contiguous().to(self.comm_device)
        boolean = src.dtype == torch.bool
        if boolean:  # not every backend reduces or gathers bool
            src = src.to(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts)
        return (out.bool() if boolean else out).to(t.device)


def _env_cluster() -> bool:
    if any(v in os.environ for v in _ENV_MARKERS):
        return True
    if os.environ.get("CVTPU_DISTRIBUTED") == "1":
        return True
    # torchrun's variables describe a real cluster only above one process
    return "MASTER_ADDR" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1


def default_backend(device: str | torch.device | None = None) -> str:
    """NCCL where the ranks compute on CUDA devices, gloo on the CPU."""
    if device is not None:
        return "nccl" if torch.device(device).type == "cuda" else "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def _bind(dev: torch.device) -> torch.device:
    """Make a CUDA ``dev`` the current device; returns ``dev``."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> int:
    """Join the process group; returns this process's rank.

    Engages when (a) a coordinator ``host:port`` is passed (it becomes the
    ``tcp://`` init method, with ``num_processes`` as the world size and
    ``process_id`` as the rank), or (b) a cluster environment is detected:
    torchrun's ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` above one process,
    the JAX package's coordinator and pod markers, or
    ``CVTPU_DISTRIBUTED=1``.  Plain single-process runs are a no-op.
    Failures with explicit arguments propagate (a misconfigured job must
    fail, not train N times alone); the autodetect path is best effort and
    falls through to one process.  Idempotent.

    Under NCCL the process's card (``local_device``) becomes the current
    device before the group is joined, and is the group's ``device_id``."""
    backend = backend or default_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    if dist.is_initialized():
        return process_index()
    explicit = coordinator_address is not None
    if not explicit and not _env_cluster():
        return process_index()
    if explicit and (num_processes is None or process_id is None):
        raise ValueError("--coordinator needs --num-processes and --process-id")
    kwargs: dict[str, Any] = {"timeout": timeout}
    if explicit:
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        rank = int(process_id) if explicit else int(os.environ.get("RANK", 0))
        kwargs["device_id"] = _bind(local_device("cuda", rank))
    try:
        dist.init_process_group(backend, **kwargs)
    except (ValueError, RuntimeError, KeyError) as e:
        if explicit:
            raise
        logger.info("no process group from the environment (%s): one process", e)
    return process_index()


def shutdown_distributed() -> None:
    """Leave the process group (``jax.distributed.shutdown``'s
    counterpart); a no-op without one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device: str | torch.device = "cuda", rank: int | None = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (else the rank, by
    default the group's; modulo the cards, so ranks may share one) for a
    CUDA request, the CPU when asked."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index() if rank is None else rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def _device_key(dev: torch.device) -> str:
    """A name of a card that two processes on one host agree on, whatever
    their ``CUDA_VISIBLE_DEVICES``: its UUID where torch reports it."""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else dev.index}"


def check_one_rank_per_device(mesh: Mesh, key: str) -> None:
    """Raise, naming both ranks, when two ranks of the group report the
    same device ``key``.  Exchanged through the group's store, so it runs
    before the first NCCL collective, which such ranks would fail or
    hang in."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"cvtpu_mesh_device/{mesh.rank}", key)
    seen: dict[str, int] = {}
    for r in range(mesh.size):
        other = store.get(f"cvtpu_mesh_device/{r}").decode()
        if other in seen:
            raise RuntimeError(
                f"ranks {seen[other]} and {r} share the device {other}: NCCL needs one device a rank "
                "(start at most one process per card, or use gloo)"
            )
        seen[other] = r


def create_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every process of the group (one process, no group:
    a mesh of one).  ``n_devices``, when given, must equal that count:
    one process drives one device.  A CUDA device becomes the current
    device; under NCCL no two ranks may share one (raises)."""
    size = process_count()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"one process per device: the group has {size} processes, asked for {n_devices}")
    mesh = Mesh(size, process_index(), _bind(local_device(device)))
    if mesh.backend == "nccl":
        check_one_rank_per_device(mesh, _device_key(mesh.device))
    return mesh


def log_unused_cards(dev: torch.device, module: str) -> None:
    """One log line when this process, outside a process group, computes
    on one of several visible cards: how to use them all."""
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n > 1 and not dist.is_initialized():
        logger.info(
            "%d CUDA devices are visible and this process trains on %s only; to train on all of them run "
            "one process per card: NPROC=%d scripts/bin/torch_train_distributed.sh ... "
            "or torchrun --nproc-per-node %d -m %s ...",
            n, dev, n, n, module,
        )


def process_local_batch_slice(global_batch: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """(start, stop) rows of the global batch this process feeds: equal
    shares, the first ``global_batch % n`` ranks one row more."""
    n = mesh.size if mesh is not None else process_count()
    idx = mesh.rank if mesh is not None else process_index()
    per = global_batch // n
    extra = global_batch % n
    start = idx * per + min(idx, extra)
    stop = start + per + (1 if idx < extra else 0)
    return start, stop


def spans_processes(mesh: Mesh | None) -> bool:
    """True when the mesh has more than one process."""
    return mesh is not None and mesh.size > 1


def local_rows(mesh: Mesh | None, x: Any) -> Any:
    """This rank's rows of a global batch (array or tensor), unmoved."""
    if mesh is None or mesh.size == 1:
        return x
    start, stop = process_local_batch_slice(len(x), mesh)
    return x[start:stop]


def make_global_batch(mesh: Mesh | None, arr: Any) -> torch.Tensor:
    """Host batch → this rank's rows on its device.  Every process makes
    the same full global batch (seeded sampling) and uploads only its
    rows, the pairing of ``process_local_batch_slice`` and
    ``jax.make_array_from_process_local_data``.  With no mesh: the batch
    as a tensor, unmoved."""
    if mesh is None:
        return torch.as_tensor(arr)
    rows = local_rows(mesh, arr)
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """``make_global_batch`` on every array of a dict, list or tuple."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return make_global_batch(mesh, tree)


def replicate(mesh: Mesh | None, module: torch.nn.Module) -> torch.nn.Module:
    """Move ``module`` to the mesh's device and make its parameters and
    buffers rank 0's on every rank (a broadcast)."""
    if mesh is None:
        return module
    module = module.to(mesh.device)
    if mesh.backend is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                buf = t.detach().to(mesh.comm_device, copy=True)
                dist.broadcast(buf, src=0)
                t.copy_(buf.to(t.device))
    return module


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_gather(mesh: Mesh | None, tree: Any) -> Any:
    """Every rank's rows of batch-split outputs, concatenated, as numpy on
    every rank (an all-gather).  No mesh or one process: plain numpy.
    ``tree`` is an array or tensor, or a dict, list or tuple of them; the
    ranks' row counts must be equal."""
    if isinstance(tree, dict):
        return {k: host_gather(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_gather(mesh, v) for v in tree)
    if not spans_processes(mesh):
        return _to_numpy(tree)
    assert mesh is not None
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
    return _to_numpy(mesh.all_gather(t))


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Pad the batch axis up to a multiple by repeating the last row;
    returns (padded, original size).  A tensor is padded in torch on its
    own device, an array in numpy."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem:
        if isinstance(batch, torch.Tensor):
            batch = torch.cat([batch, batch[-1:].expand(rem, *batch.shape[1:])])
        else:
            batch = np.concatenate([batch, np.repeat(batch[-1:], rem, axis=0)], axis=0)
    return batch, b


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the mesh: the backward of a sum is the sum
    of the ranks' upstream gradients, so every rank's inputs get the
    gradient of the ranks' summed losses."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:  # type: ignore[override]
        ctx.mesh = mesh
        return mesh.all_reduce_sum(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor, None]:  # type: ignore[override]
        return ctx.mesh.all_reduce_sum(grad.contiguous()), None


def all_reduce_sum_differentiable(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``torch.distributed.nn.functional.all_reduce`` (SUM) through
    ``Mesh.all_reduce_sum``, so it also runs where gloo's ranks compute
    on a GPU (the collective then goes through host memory)."""
    return _AllReduceSum.apply(x, mesh)


def average_gradients(mesh: Mesh | None, grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean of each gradient over the ranks: one all-reduce of the
    flattened list (one bucket), then divided by the size."""
    if mesh is None or mesh.backend is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = mesh.all_reduce_sum(flat) / mesh.size
    out, i = [], 0
    for g in grads:
        out.append(flat[i : i + g.numel()].view_as(g))
        i += g.numel()
    return out


def mean_over_mesh(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of a per-rank scalar (a metric that is a mean over
    equal row counts)."""
    if mesh is None or mesh.backend is None:
        return x
    return mesh.all_reduce_sum(x.detach().float()) / mesh.size
