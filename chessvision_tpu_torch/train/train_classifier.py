"""Piece classifier trainer, the counterpart of
``chessvision_tpu/train/train_classifier.py``.

Adam on cross entropy (optional label smoothing) with the reference's
StepLR as ``exponential_decay(staircase=True)`` or a warm-up cosine,
both functions of the update count; early stopping; best-val-accuracy
checkpoints with optimizer state in the JAX package's ``.npz`` layout;
optional augmentation (composed affine + rotation warp, kernel K1 on the
GPU; ``--cutout/--aug-dim/--aug-fade``), ``freeze_bn``, an EMA of the
parameters, sample weights, extra data, and per-sample metrics with
embeddings on collection epochs.  One process on one device (the GPU
unless ``device="cpu"``); bfloat16 convolutions over float32 master
weights on the GPU.  Inputs are /255 in training and serving alike.

Run: python -m chessvision_tpu_torch.train.train_classifier --epochs 10 ...
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.utils import default_train_dtype, resolve_device, setup_logger

logger = logging.getLogger(__name__)

PIECE_CLASSIFICATION_PROJECT = "chessvision-classification"

LR_SCHEDULER_STEP_SIZE = 4
LR_SCHEDULER_GAMMA = 0.1


def train_model(
    *,
    model_id: str = "resnet18",
    epochs: int = 10,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    run_name: str | None = None,
    run_description: str | None = None,
    use_sample_weights: bool = False,
    collection_frequency: int = 5,
    patience: int = 5,
    seed: int = 42,
    augment: bool = True,
    model_dtype: torch.dtype | None = None,
    use_mesh: bool = True,
    width: int | None = None,
    lr_step_size: int = LR_SCHEDULER_STEP_SIZE,
    lr_gamma: float = LR_SCHEDULER_GAMMA,
    resume: str | None = None,
    label_smoothing: float = 0.0,
    freeze_bn: bool = False,
    ema_decay: float = 0.0,
    schedule_kind: str = "step",
    cutout: bool = False,
    aug_dim: bool = False,
    aug_fade: bool = False,
    extra_data: list[str] | None = None,
    extra_weight: float = 1.0,
    device: str | torch.device = "cuda",
) -> tuple[Any, str]:
    """Train; returns (run, checkpoint path).  With ``use_mesh`` and a
    process group the batch splits over the ranks as in
    ``train_unet.train_model``; rank 0 owns the run and the checkpoints."""
    from chessvision_tpu_torch import models, runstore
    from chessvision_tpu_torch.checkpoint import load_checkpoint, load_metadata, save_checkpoint
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.runstore import metrics as collectors
    from chessvision_tpu_torch.train import data as data_lib
    from chessvision_tpu_torch.train import losses, steps
    from chessvision_tpu_torch.train.augment import augment_classification_batch, fold_in

    dev = resolve_device(device)
    if model_dtype is None:
        model_dtype = default_train_dtype(dev)

    # same loop on every rank over the same seeded data order; only rank 0
    # owns the run directory, the logs and the checkpoints
    is_main = mesh_lib.process_index() == 0
    run = runstore.NullRun() if not is_main else runstore.init(
        PIECE_CLASSIFICATION_PROJECT,
        run_name,
        parameters={
            "model_id": model_id,
            "epochs": epochs,
            "batch_size": batch_size,
            "learning_rate": learning_rate,
            "use_sample_weights": use_sample_weights,
            "augment": augment,
            "seed": seed,
            "extra_data": list(extra_data or []),
            "extra_weight": extra_weight,
        },
        description=run_description,
    )
    checkpoint_path = str(run.bulk_data_url / "checkpoint.npz")

    data = data_lib.load_squares()
    n_extra = 0
    for extra_dir in extra_data or []:
        imgs_e, labels_e, ids_e = data_lib.load_squares_dir(extra_dir, data.class_names)
        data.train_images = np.concatenate([data.train_images, imgs_e])
        data.train_labels = np.concatenate([data.train_labels, labels_e])
        data.train_ids = data.train_ids + ids_e
        n_extra += len(ids_e)
        logger.info("Appended %d extra training squares from %s", len(ids_e), extra_dir)
    n_train, n_val = len(data.train_labels), len(data.val_labels)
    logger.info("Training on %d / validating on %d squares", n_train, n_val)

    mesh = None
    if use_mesh and torch.distributed.is_initialized():
        mesh = mesh_lib.create_mesh(device=dev)
        dev = mesh.device
        batch_size -= batch_size % mesh.size
    else:
        mesh_lib.log_unused_cards(dev, __name__)

    if resume:
        tc = (load_metadata(resume) or {}).get("training_config", {})
        for name, current in (("model_id", model_id), ("width", width)):
            if name in tc and tc[name] != current:
                logger.warning("resume: adopting %s=%r from checkpoint (requested %r)", name, tc[name], current)
        model_id = tc.get("model_id", model_id)
        width = tc.get("width", width)

    kwargs = {"width": width} if width else {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _ = models.create_classifier(model_id, **kwargs)
    model = mesh_lib.replicate(mesh, set_compute_dtype(model, model_dtype, master_weights=True).to(dev))
    rng_np = np.random.default_rng(seed)
    aug_key = fold_in(seed, "augment")

    steps_per_epoch = max(1, n_train // batch_size)
    if schedule_kind == "cosine":
        # cosine to zero over the run after a 2-epoch linear warm-up
        schedule = steps.warmup_cosine_decay_schedule(
            init_value=learning_rate / 25,
            peak_value=learning_rate,
            warmup_steps=2 * steps_per_epoch,
            decay_steps=epochs * steps_per_epoch,
        )
    else:
        # StepLR(step_size=4, gamma=0.1), the reference's schedule
        schedule = steps.exponential_decay(
            learning_rate, transition_steps=lr_step_size * steps_per_epoch, decay_rate=lr_gamma, staircase=True
        )
    state = steps.TrainState.create(model, steps.adam(schedule))

    start_epoch = 1
    resumed_ema = None
    if resume:
        loaded, res_meta = load_checkpoint(resume)
        steps.restore(state, loaded)
        if "ema_params" in loaded:
            resumed_ema = steps.params_from_tree(state, loaded["ema_params"])
        start_epoch = int(res_meta.get("epoch", 0)) + 1
        logger.info("Resumed from %s at epoch %d", resume, start_epoch)
        if start_epoch > epochs:
            raise ValueError(
                f"--resume checkpoint is at epoch {start_epoch - 1} but --epochs is "
                f"{epochs}: no epochs would run (epochs counts TOTAL epochs across "
                f"resumes). Pass --epochs > {start_epoch - 1} to fine-tune."
            )

    train_step = steps.make_cls_train_step(mesh, label_smoothing=label_smoothing, freeze_bn=freeze_bn)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def put(a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a global batch, on its device."""
        return to_dev(a) if mesh is None else mesh_lib.make_global_batch(mesh, a)

    def collect_step(images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            logits, features = model(images, return_features=True)
            m = collectors.classification_metrics(logits, labels)
            m.update(collectors.top2_margin_and_entropy(torch.softmax(logits, dim=-1)))
            m["embedding"] = features
        return m

    def run_validation() -> tuple[float, float]:
        total_loss, correct, total = 0.0, 0, 0
        model.eval()
        for idx in data_lib.batches(n_val, 512):
            idx, real = data_lib.pad_indices(idx, 512)
            imgs = put(data.val_images[idx].astype(np.float32)[..., None] / 255.0)
            labs = put(np.asarray(data.val_labels[idx]))
            real_rows = put(np.arange(len(idx)) < real)
            with torch.no_grad():
                logits = model(imgs)
                loss = mesh_lib.mean_over_mesh(mesh, losses.cross_entropy(logits, labs))
                n_ok = torch.sum((torch.argmax(logits, -1) == labs) & real_rows)
                if mesh is not None:
                    n_ok = mesh.all_reduce_sum(n_ok)
            total_loss += float(loss) * real  # padded duplicates shift the loss negligibly
            correct += int(n_ok)
            total += real
        return total_loss / total, correct / total

    collection_epochs = list(range(collection_frequency, epochs + 1, collection_frequency))
    if epochs not in collection_epochs:
        collection_epochs.append(epochs)

    training_config: dict[str, Any] = {
        "model_id": model_id,
        "epochs": epochs,
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "run_name": run.name,
    }
    if width:
        training_config["width"] = width
    weights = None
    if use_sample_weights:
        from chessvision_tpu_torch.train.tables import get_or_create_classification_tables, sample_weights_for_ids

        try:
            tables = get_or_create_classification_tables()
            weights = sample_weights_for_ids(tables["train"], data.train_ids)
        except Exception:  # noqa: BLE001 — the table store is optional for training
            logger.exception("no sample weights from the dataset tables")
            weights = None
        if weights is None:
            # inverse class frequency
            counts = np.bincount(data.train_labels, minlength=constants.NUM_CLASSES)
            weights = (1.0 / np.maximum(counts, 1))[data.train_labels]
    if n_extra and extra_weight != 1.0:
        if weights is None:
            weights = np.ones(n_train, np.float64)
        weights = np.asarray(weights, np.float64)
        weights[-n_extra:] *= extra_weight

    ema_params = None
    if ema_decay > 0:
        src = resumed_ema if resumed_ema is not None else [p.detach() for p in state.params]
        ema_params = [t.clone() for t in src]

    best_val_acc = float("-inf")
    patience_counter = 0
    start_time = time.time()
    final_epoch = 0
    global_step = 0

    for epoch in range(start_epoch, epochs + 1):
        final_epoch = epoch
        epoch_loss, correct_sum, seen = 0.0, 0.0, 0
        for idx in data_lib.batches(n_train, batch_size, rng=rng_np, weights=weights, drop_last=True):
            imgs = put(data.train_images[idx].astype(np.float32)[..., None] / 255.0)
            if augment:
                # this rank's rows only, with the global batch's draws
                imgs = augment_classification_batch(
                    fold_in(aug_key, global_step), imgs, cutout=cutout, dim=aug_dim, fade=aug_fade,
                    rows=None if mesh is None else mesh_lib.process_local_batch_slice(len(idx), mesh),
                    global_batch=len(idx),
                )
            labs = put(np.asarray(data.train_labels[idx]))
            metrics = train_step(state, imgs, labs)
            if ema_params is not None:
                ema_params = steps.ema_update(ema_params, state.params, ema_decay)
            global_step += 1
            loss_acc = torch.stack([metrics["loss"], metrics["accuracy"]]).tolist()
            epoch_loss += loss_acc[0] * len(idx)
            correct_sum += loss_acc[1] * len(idx)
            seen += len(idx)

        with steps.params_swapped(state, ema_params):
            val_loss, val_acc = run_validation()
        run.log(
            {
                "epoch": epoch,
                "train_loss": epoch_loss / max(seen, 1),
                "train_accuracy": correct_sum / max(seen, 1),
                "val_loss": val_loss,
                "val_accuracy": val_acc,
            }
        )
        logger.info(
            "epoch %d train_acc %.4f val_acc %.4f val_loss %.4f", epoch, correct_sum / max(seen, 1), val_acc, val_loss
        )

        if val_acc > best_val_acc:
            best_val_acc = val_acc
            patience_counter = 0
            if is_main:
                save_checkpoint(
                    checkpoint_path,
                    steps.checkpoint_variables(state, ema_params),
                    {"best_val_score": best_val_acc, "epoch": epoch, "training_config": training_config},
                    opt_state=state.opt_state_leaves(),
                )
                logger.info("Checkpoint %d saved (val acc %.4f)", epoch, best_val_acc)
        else:
            patience_counter += 1

        if epoch in collection_epochs and mesh_lib.spans_processes(mesh):
            logger.info("Skipping metrics collection (multi-process mesh)")
        elif epoch in collection_epochs:
            for split, imgs_a, labs_a, ids in (
                ("train", data.train_images, data.train_labels, data.train_ids),
                ("val", data.val_images, data.val_labels, data.val_ids),
            ):
                rows: dict[str, list] = {}
                for idx in data_lib.batches(len(labs_a), 512):
                    idx, real = data_lib.pad_indices(idx, 512)
                    m = collect_step(
                        to_dev(imgs_a[idx].astype(np.float32)[..., None] / 255.0), to_dev(np.asarray(labs_a[idx]))
                    )
                    for k, v in collectors.to_numpy(m).items():
                        rows.setdefault(k, []).append(v[:real])
                cols = {k: np.concatenate(v) for k, v in rows.items()}
                cols["example_id"] = np.asarray(ids, object)
                name = f"{split}_epoch{epoch}"
                run.write_metrics_table(name, cols)
                run.reduce_embeddings(name, "embedding")

        if patience_counter >= patience and epoch != epochs:
            logger.info("Early stopping after %d epochs", epoch)
            break

    training_time = time.time() - start_time
    run.set_parameters(
        {
            "best_val_score": best_val_acc,
            "model_path": checkpoint_path,
            "final_epoch": final_epoch,
            "training_time": training_time,
        }
    )
    run.set_status_completed()
    logger.info("Training done in %.0fs, best val acc %.4f", training_time, best_val_acc)
    return run, checkpoint_path


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the piece classifier (PyTorch)")
    parser.add_argument("--model-id", type=str, default="resnet18", help="resnet18 or yolo")
    parser.add_argument("--run-name", type=str, default=None)
    parser.add_argument("--run-description", type=str, default=None)
    parser.add_argument("--skip-eval", action="store_true")
    parser.add_argument("--use-sample-weights", action="store_true")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--collection-frequency", type=int, default=5)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--no-augment", action="store_true", default=False)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--lr-step-size", type=int, default=LR_SCHEDULER_STEP_SIZE)
    parser.add_argument("--lr-gamma", type=float, default=LR_SCHEDULER_GAMMA)
    parser.add_argument("--resume", type=str, default=None, help="checkpoint to resume from (either package's)")
    parser.add_argument("--label-smoothing", type=float, default=0.0)
    parser.add_argument("--freeze-bn", action="store_true", help="fine-tune with frozen BatchNorm running stats")
    parser.add_argument("--ema-decay", type=float, default=0.0, help="validate/checkpoint an EMA of params (0 = off)")
    parser.add_argument("--schedule", choices=("step", "cosine"), default="step", help="LR schedule: StepLR or warmup-cosine")
    parser.add_argument("--cutout", action="store_true", help="random-erasing augmentation")
    parser.add_argument("--aug-dim", action="store_true", help="heavy per-square dimming, U(0.3,0.75) at p=0.25")
    parser.add_argument("--aug-fade", action="store_true", help="contrast fade toward paper white at p=0.25")
    parser.add_argument("--extra-data", action="append", default=None, help="extra ImageFolder of 64-px squares for the TRAIN split")
    parser.add_argument("--extra-weight", type=float, default=1.0, help="relative sampling weight of --extra-data examples")
    parser.add_argument("--promote", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--coordinator", type=str, default=None, help="multi-process: coordinator host:port (tcp://)")
    parser.add_argument("--num-processes", type=int, default=None, help="multi-process: process count")
    parser.add_argument("--process-id", type=int, default=None, help="multi-process: this process's rank")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = get_args(argv)
    setup_logger("chessvision_tpu_torch")
    from chessvision_tpu_torch.parallel import mesh as mesh_lib

    # leave the group at the end only where this call joined it
    joined = not torch.distributed.is_initialized()
    mesh_lib.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, backend=mesh_lib.default_backend(args.device)
    )
    try:
        _run(args)
    finally:
        if joined:
            mesh_lib.shutdown_distributed()


def _run(args: argparse.Namespace) -> None:
    """Train, then on rank 0 promote and evaluate."""
    from chessvision_tpu_torch.parallel import mesh as mesh_lib

    run, checkpoint_path = train_model(
        model_id=args.model_id,
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        run_name=args.run_name,
        run_description=args.run_description,
        use_sample_weights=args.use_sample_weights,
        collection_frequency=args.collection_frequency,
        patience=args.patience,
        seed=args.seed,
        augment=not args.no_augment,
        width=args.width,
        lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma,
        resume=args.resume,
        label_smoothing=args.label_smoothing,
        freeze_bn=args.freeze_bn,
        ema_decay=args.ema_decay,
        schedule_kind=args.schedule,
        cutout=args.cutout,
        aug_dim=args.aug_dim,
        aug_fade=args.aug_fade,
        extra_data=args.extra_data,
        extra_weight=args.extra_weight,
        device=args.device,
    )
    if mesh_lib.process_index() != 0:
        return  # promotion and evaluation are rank 0's
    from pathlib import Path

    from chessvision_tpu_torch.checkpoint import promote_checkpoint

    default = constants.BEST_YOLO_CLASSIFIER if args.model_id == "yolo" else constants.BEST_CLASSIFIER_WEIGHTS
    if args.promote or not Path(default).exists():
        promote_checkpoint(checkpoint_path, default)
        logger.info("Promoted checkpoint to %s", default)

    if not args.skip_eval:
        from chessvision_tpu_torch.eval.evaluate import evaluate_model

        evaluate_model(run=run, classifier_weights=checkpoint_path, classifier_model_id=args.model_id, device=args.device)


if __name__ == "__main__":
    main()
