"""Entry points of the PyTorch port: the flagship forward as one callable,
and a dry run of training and sharded inference over several ranks.  The
counterpart of ``__graft_entry__.py``.

    python3 graft_entry_torch.py [--cards N] [--device cuda|cpu]

runs ``entry()``'s forward once, then ``dryrun_multichip(N)``: one process a
card over NCCL (N defaults to every visible card), or, with ``--device
cpu``, N processes over gloo (2 by default).  It imports torch, numpy, the
standard library and ``chessvision_tpu_torch`` only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch import models
from chessvision_tpu_torch.models.layers import set_compute_dtype
from chessvision_tpu_torch.parallel import mesh as mesh_lib
from chessvision_tpu_torch.train import steps
from chessvision_tpu_torch.utils import full_f32, resolve_device

SEED = 0
DRYRUN_TIMEOUT_S = 900.0  # a rank that has not finished by then is stopped


def _seeded(build: Callable[[], Any]) -> Any:
    """``build()`` with torch's CPU generator seeded (the models are made
    on the CPU); the caller's generator is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(SEED)
        return build()


def entry(device: str | torch.device = "cuda", batch: int = 8) -> tuple[Callable[..., dict[str, torch.Tensor]], tuple]:
    """Return ``(fn, (images, threshold))``: the fused image→FEN forward of
    the flagship configuration (the registry's UNet, base 64, and ResNet18,
    bfloat16 convolutions, random weights from a seed), the counterpart of
    ``__graft_entry__.entry``.  ``fn(images, threshold)`` takes (B, H, W, 3)
    uint8 BGR frames and a 0-d float32 threshold on the device and returns
    the pipeline's dict of device tensors (``refine="arbitrate"``) without
    a host sync.  The examples are ``batch`` zero frames of 512² and 0.5.
    Runs on the card; ``device="cpu"`` runs the plain path."""
    dev = resolve_device(device)

    def build() -> tuple[torch.nn.Module, torch.nn.Module, bool]:
        extractor, _ = models.create_extractor("unet")
        classifier, cl_spec = models.create_classifier("resnet18")
        return extractor, classifier, cl_spec.outputs_probabilities

    extractor, classifier, outputs_probabilities = _seeded(build)
    extractor = set_compute_dtype(extractor, torch.bfloat16).to(dev).eval()
    classifier = set_compute_dtype(classifier, torch.bfloat16).to(dev).eval()

    def fn(images: torch.Tensor, threshold: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.inference_mode(), full_f32():
            comp, gray = engine_mod.preprocess_images(images)
            return engine_mod._pipeline_core(
                extractor, classifier, outputs_probabilities, comp.float(), gray.float(), threshold, "arbitrate"
            )

    images = torch.zeros((batch, 512, 512, 3), dtype=torch.uint8, device=dev)
    threshold = torch.tensor(0.5, dtype=torch.float32, device=dev)
    return fn, (images, threshold)


def _train_state(model: torch.nn.Module, mesh: mesh_lib.Mesh, tx: steps.Transform) -> steps.TrainState:
    """bfloat16 convolutions over float32 master weights (the JAX modules'
    default dtype), on the mesh's device, rank 0's parameters on every rank."""
    set_compute_dtype(model, torch.bfloat16, master_weights=True)
    return steps.TrainState.create(mesh_lib.replicate(mesh, model.to(mesh.device)), tx)


def _dryrun_rank(
    rank: int, world: int, coordinator: str | None, device: str, probe: Callable[[], Any] | None = None
) -> dict[str, Any]:
    """One rank of the dry run: join the group (unless ``coordinator`` is
    None: a mesh of one in this process), one segmentation step, one
    classification step and one ``Engine(mesh=…)`` batch, as
    ``__graft_entry__.dryrun_multichip``; then check that the losses are
    finite and equal rank 0's.  Returns this rank's record (with
    ``probe()``'s value, taken after a barrier)."""
    if coordinator is not None:
        mesh_lib.initialize_distributed(
            coordinator, world, rank, backend=mesh_lib.default_backend(device)
        )
    try:
        mesh = mesh_lib.create_mesh(world, device=device)

        # segmentation training step (UNet base 8, BCE + dice, RMSprop)
        unet = _seeded(lambda: models.create_extractor("unet", base=8)[0])
        tx = steps.make_optimizer("rmsprop", 1e-4, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0)
        state = _train_state(unet, mesh, tx)
        images = mesh_lib.make_global_batch(mesh, np.zeros((world * 2, 64, 64, 3), np.float32))
        masks = mesh_lib.make_global_batch(mesh, np.zeros((world * 2, 64, 64), np.float32))
        metrics = steps.make_seg_train_step(mesh)(state, images, masks)

        # classification training step (ResNet18 width 8, cross entropy, Adam)
        cls = _seeded(lambda: models.create_classifier("resnet18", width=8)[0])
        cstate = _train_state(cls, mesh, steps.make_optimizer("adam", 1e-3))
        cimgs = mesh_lib.make_global_batch(mesh, np.zeros((world * 4, 64, 64, 1), np.float32))
        clabels = mesh_lib.make_global_batch(mesh, np.zeros((world * 4,), np.int64))
        cmetrics = steps.make_cls_train_step(mesh)(cstate, cimgs, clabels)

        # sharded fused inference engine (the YOLO pair at width 8)
        def pair() -> tuple[torch.nn.Module, torch.nn.Module, bool]:
            ex, _ = models.create_extractor("yolo", width=8)
            cl, cl_spec = models.create_classifier("yolo", width=8)
            return ex, cl, cl_spec.outputs_probabilities

        ex, cl, outputs_probabilities = _seeded(pair)
        eng = engine_mod.Engine(
            set_compute_dtype(ex, torch.bfloat16),
            set_compute_dtype(cl, torch.bfloat16),
            classifier_outputs_probabilities=outputs_probabilities,
            mesh=mesh,
        )
        result = eng.process_batch(np.zeros((world, 512, 512, 3), np.uint8))
        if result.probabilities.shape != (world, 64, 13):
            raise AssertionError(f"engine batch {result.probabilities.shape}, expected {(world, 64, 13)}")

        seg_loss, cls_loss = float(metrics["loss"]), float(cmetrics["loss"])
        if not (math.isfinite(seg_loss) and math.isfinite(cls_loss)):
            raise FloatingPointError(f"rank {mesh.rank}: seg loss {seg_loss}, cls loss {cls_loss}")
        if mesh.backend is not None:
            ref = torch.tensor([seg_loss, cls_loss], dtype=torch.float64, device=mesh.comm_device)
            torch.distributed.broadcast(ref, src=0)
            if ref.tolist() != [seg_loss, cls_loss]:
                raise AssertionError(f"rank {mesh.rank}: losses {[seg_loss, cls_loss]}, rank 0's {ref.tolist()}")
            torch.distributed.barrier()
        line = (
            f"dryrun_multichip ok on {world} devices: "
            f"seg loss {seg_loss:.4f}, cls loss {cls_loss:.4f}, "
            f"engine batch {result.probabilities.shape}"
        )
        if mesh.rank == 0:
            print(line, flush=True)
        return {
            "rank": mesh.rank, "world": mesh.size, "device": str(mesh.device), "backend": mesh.backend,
            "pid": os.getpid(), "seg_loss": seg_loss, "cls_loss": cls_loss,
            "engine_batch": list(result.probabilities.shape), "line": line,
            "probe": probe() if probe is not None else None,
        }
    finally:
        if coordinator is not None:
            mesh_lib.shutdown_distributed()


def _spawned_rank(
    rank: int, world: int, coordinator: str, device: str, out_dir: str, probe: Callable[[], Any] | None
) -> None:
    """A process of the dry run (``torch.multiprocessing``'s entry): this
    rank's card is ``cuda:<rank>``; collectives go over loopback."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    rec = _dryrun_rank(rank, world, coordinator, device, probe)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(
    n_devices: int,
    device: str | torch.device = "cuda",
    *,
    probe: Callable[[], Any] | None = None,
) -> list[dict[str, Any]]:
    """One step of each training program and a sharded ``Engine`` batch
    over ``n_devices`` ranks (the counterpart of
    ``__graft_entry__.dryrun_multichip``): the segmentation step (UNet base
    8, RMSprop, 2 rows of 64² a rank), the classification step (ResNet18
    width 8, Adam, 4 rows a rank) and ``Engine(mesh=…)`` with the YOLO pair
    at width 8 on ``n_devices`` zero 512² frames.  Rank 0 prints one line.

    On the card: one process a card over NCCL (``cuda:0`` … ``cuda:N-1``);
    raises when fewer than ``n_devices`` cards are visible.  ``device="cpu"``:
    processes over gloo.  ``n_devices=1`` runs in this process on a mesh of
    one.  Every rank checks its losses are finite and equal rank 0's; a
    failing rank makes the call raise.  Returns the ranks' records, with
    ``probe()`` (a module-level function, run in each rank after a barrier)
    where given."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs one rank a card and this machine shows "
            f"{torch.cuda.device_count()}"
        )
    if n_devices == 1:
        return [_dryrun_rank(0, 1, None, dev.type, probe)]
    coordinator = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="graft-dryrun-") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _spawned_rank, args=(n_devices, coordinator, dev.type, out_dir, probe), nprocs=n_devices,
            join=False, start_method="spawn",
        )
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dryrun_multichip({n_devices}) did not finish in {DRYRUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        recs = []
        for r in range(n_devices):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    return recs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="ranks of the dry run (default: every visible card; 2 with --device cpu)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    shapes = {k: [list(v.shape), str(v.dtype).removeprefix("torch.")] for k, v in out.items()}
    print(f"entry ok on {example[0].device}: {json.dumps(shapes)}", flush=True)
    n = args.cards or (torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
