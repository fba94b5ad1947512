"""The port's data-parallel cases, run by every rank of a gloo group and by
the one-process reference alike (tests/test_torch_mesh.py).

As a script it is one rank: ``python tests/_torch_mesh_worker.py RANK WORLD
INIT_FILE IN_DIR OUT_DIR`` joins a gloo group through a file store, builds
the CPU mesh, runs the train steps, ``process_batch``, the raw stream and
``run_device`` on a tensor, and writes ``OUT_DIR/rank{RANK}.npz``; ``python
tests/_torch_mesh_worker.py trainers RANK WORLD PORT`` runs both trainers'
command lines as that rank (``trainer_argv``) on the tiny datasets of
tests/_trainer_parity.py; ``python tests/_torch_mesh_worker.py cls RANK
WORLD INIT_FILE IN_DIR OUT_DIR`` runs the classifier step alone with plain
SGD, and the same step without the collectives as a control, and writes
``OUT_DIR/cls{RANK}.npz``.  It imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chessvision_tpu_torch import models, weights  # noqa: E402
from chessvision_tpu_torch.engine import Engine  # noqa: E402
from chessvision_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from chessvision_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from chessvision_tpu_torch.train import steps  # noqa: E402

SEG_LR = 1e-3
CLS_LR = 1e-3
# plain SGD at a unit rate for the four-rank case: a parameter moves by
# minus its gradient, so the parameters after the step carry the gradient
CLS_SGD_LR = 1.0
STUB_QUAD = [[32, 28], [224, 30], [226, 228], [30, 226]]


def seg_batch() -> tuple[np.ndarray, np.ndarray]:
    """The global segmentation batch: 8 images of 32² (4 a rank at two)."""
    rng = np.random.default_rng(0)
    return rng.random((8, 32, 32, 3)).astype(np.float32), (rng.random((8, 32, 32)) > 0.5).astype(np.float32)


def cls_batch() -> tuple[np.ndarray, np.ndarray]:
    """The global classifier batch: 16 squares of 64²."""
    rng = np.random.default_rng(1)
    return rng.random((16, 64, 64, 1)).astype(np.float32), (np.arange(16) % 13).astype(np.int64)


def engine_batch() -> np.ndarray:
    """3 frames of 256²: padded to 4, two boards a rank."""
    return np.random.default_rng(42).integers(0, 256, (3, 256, 256, 3), np.uint8)


def _state(model: torch.nn.Module, state_dict: dict, tx: steps.Transform) -> steps.TrainState:
    model.load_state_dict(state_dict)
    set_compute_dtype(model, torch.float32, master_weights=True)
    return steps.TrainState.create(model, tx)


def _record(prefix: str, state: steps.TrainState, metrics: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    out = {f"{prefix}/{k}": v.detach().numpy() for k, v in metrics.items()}
    sq = sum(float(torch.sum(p.detach().double() ** 2)) for p in state.params)
    out[f"{prefix}/param_norm"] = np.float64(np.sqrt(sq))
    for k, v in weights._flatten(weights.torch_to_flax(state.model)).items():
        out[f"{prefix}/state/" + "/".join(k)] = v
    return out


def seg_step(mesh: mesh_lib.Mesh | None, state_dict: dict) -> dict[str, np.ndarray]:
    """One step of the UNet trainer's optimizer chain on this rank's rows."""
    state = _state(
        models.UNet(base=4),
        state_dict,
        steps.make_optimizer("rmsprop", SEG_LR, weight_decay=1e-8, momentum=0.999, gradient_clipping=1.0),
    )
    x, y = seg_batch()
    m = steps.make_seg_train_step(mesh)(state, mesh_lib.make_global_batch(mesh, x), mesh_lib.make_global_batch(mesh, y))
    return _record("seg", state, m)


def cls_step(
    mesh: mesh_lib.Mesh | None, state_dict: dict, tx: steps.Transform | None = None, collectives: bool = True,
    prefix: str = "cls",
) -> dict[str, np.ndarray]:
    """One step of a ResNet18 (width 8) on this rank's rows (Adam unless
    ``tx``); without ``collectives`` the step runs on those rows alone, as
    a lost all-reduce would."""
    state = _state(models.resnet18(width=8), state_dict, tx or steps.adam(CLS_LR))
    x, labels = cls_batch()
    step = steps.make_cls_train_step(mesh if collectives else None)
    m = step(state, mesh_lib.make_global_batch(mesh, x), mesh_lib.make_global_batch(mesh, labels))
    return _record(prefix, state, m)


class FixedQuadExtractor(torch.nn.Module):
    """+8 logits inside a fixed quadrangle, −8 outside, whatever the input
    (``tests/distributed_worker.py``'s stub)."""

    def __init__(self) -> None:
        super().__init__()
        import cv2

        mask = np.zeros((256, 256), np.uint8)
        cv2.fillConvexPoly(mask, np.array(STUB_QUAD, np.int32), 255)
        self.register_buffer("logits", torch.from_numpy(np.where(mask > 0, 8.0, -8.0).astype(np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits[None, :, :, None].expand(x.shape[0], 256, 256, 1)


def build_engine(mesh: mesh_lib.Mesh | None, yolo_state_dict: dict) -> Engine:
    """The stub extractor and a seeded YoloCls (width 8), arbitrate with
    chunks of 2 boards, as the JAX package's parity engine."""
    classifier, spec = models.create_classifier("yolo", width=8)
    classifier.load_state_dict(yolo_state_dict)
    return Engine(
        FixedQuadExtractor(),
        set_compute_dtype(classifier, torch.float32),
        classifier_outputs_probabilities=spec.outputs_probabilities,
        refine_grid="arbitrate",
        arbitrate_chunk=2,
        device="cpu",
        mesh=mesh,
    )


def engine_record(mesh: mesh_lib.Mesh | None, yolo_state_dict: dict) -> dict[str, np.ndarray]:
    r = build_engine(mesh, yolo_state_dict).process_batch(engine_batch(), threshold=0.5)
    return {
        "engine/fens": np.asarray(r.fens),
        "engine/found": np.asarray(r.board_found),
        "engine/probabilities": r.probabilities,
        "engine/quadrangle": r.quadrangle,
        "engine/board_image": r.board_image,
        "engine/logits": r.logits,
        "engine/binary_mask": r.binary_mask,
    }


def stream_record(mesh: mesh_lib.Mesh | None, yolo_state_dict: dict) -> dict[str, np.ndarray]:
    """The whole batch through ``run_stream(kind="raw")``, which never
    splits it over the ranks; ``stream/tensors`` is 1 when every output
    came back as a tensor.  On a mesh, also ``run_device`` given the batch
    as a tensor (padded in torch, gathered to the host)."""
    engine = build_engine(mesh, yolo_state_dict)
    (out,) = list(engine.run_stream([engine_batch()], threshold=0.5, kind="raw"))
    rec = {"stream/tensors": np.int64(all(isinstance(v, torch.Tensor) for v in out.values()))}
    rec.update({f"stream/{k}": v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)})
    if mesh is not None:
        dev = engine.run_device(torch.from_numpy(engine_batch()), threshold=0.5)
        rec.update({f"tensor_input/{k}": np.asarray(v) for k, v in dev.items()})
    return rec


def patch_datasets() -> None:
    """Point the port's loaders at tests/_trainer_parity.py's datasets."""
    from chessvision_tpu_torch.train import data as data_lib
    from tests import _trainer_parity

    data_lib.load_board_extraction = lambda *a, **k: _trainer_parity.seg_data(data_lib)
    data_lib.load_squares = lambda *a, **k: _trainer_parity.cls_data(data_lib)


def trainer_argv(kind: str, run_name: str) -> list[str]:
    common = ["--device", "cpu", "--epochs", "1", "--skip-eval", "--seed", "0", "--run-name", run_name]
    if kind == "unet":
        return common + ["--batch-size", "4", "--base", "4"]
    return common + ["--batch-size", "8", "--width", "8"]


def run_trainers(rank: int, world: int, port: int) -> None:
    from chessvision_tpu_torch.train import train_classifier, train_unet

    patch_datasets()
    cluster = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id", str(rank)]
    # one group for both command lines: a ``main`` leaves only a group it joined
    mesh_lib.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    train_unet.main(trainer_argv("unet", "mesh") + cluster)
    train_classifier.main(trainer_argv("resnet18", "mesh") + cluster)
    mesh_lib.shutdown_distributed()


def main(argv: list[str]) -> int:
    if argv[0] == "trainers":
        torch.set_num_threads(2)
        run_trainers(int(argv[1]), int(argv[2]), int(argv[3]))
        return 0
    if argv[0] == "cls":  # the classifier step alone, for the four-rank case
        rank, world, init_file, in_dir, out_dir = int(argv[1]), int(argv[2]), argv[3], Path(argv[4]), Path(argv[5])
        torch.set_num_threads(1)
        torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
        mesh = mesh_lib.create_mesh(device="cpu")
        rec = {"rank": np.int64(mesh.rank), "size": np.int64(mesh.size)}
        rec["slice"] = np.asarray(mesh_lib.process_local_batch_slice(len(cls_batch()[1]), mesh))
        sd = torch.load(in_dir / "resnet.pt")
        rec.update(cls_step(mesh, sd, steps.scale_by_learning_rate(CLS_SGD_LR)))
        rec.update(cls_step(mesh, sd, steps.scale_by_learning_rate(CLS_SGD_LR), collectives=False, prefix="control"))
        np.savez(out_dir / f"cls{rank}.npz", **rec)
        mesh_lib.shutdown_distributed()
        return 0
    rank, world, init_file, in_dir, out_dir = int(argv[0]), int(argv[1]), argv[2], Path(argv[3]), Path(argv[4])
    torch.set_num_threads(2)
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    mesh = mesh_lib.create_mesh(device="cpu")
    rec: dict[str, np.ndarray] = {"rank": np.int64(mesh.rank), "size": np.int64(mesh.size)}
    rec["slice"] = np.asarray(mesh_lib.process_local_batch_slice(8, mesh))
    rec.update(seg_step(mesh, torch.load(in_dir / "unet.pt")))
    rec.update(cls_step(mesh, torch.load(in_dir / "resnet.pt")))
    rec.update(engine_record(mesh, torch.load(in_dir / "yolo.pt")))
    rec.update(stream_record(mesh, torch.load(in_dir / "yolo.pt")))
    np.savez(out_dir / f"rank{rank}.npz", **rec)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
