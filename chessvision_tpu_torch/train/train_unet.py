"""Segmentation (board extraction) trainer, the counterpart of
``chessvision_tpu/train/train_unet.py``.

RMSprop(momentum 0.999, wd 1e-8) on BCE + dice, gradient clip 1.0, mid-epoch
validations driving a plateau learning rate (mode max, patience 3, factor
0.1) written into the optimizer state, best-dice checkpoints with metadata
and optimizer state in the JAX package's ``.npz`` layout, early stopping,
optional augmentation (two-pass warp, kernel K1 on the GPU), sample-weight
sampling, an EMA of the parameters, the quadrangle geometry guard, extra
training data, per-sample metrics and embeddings on collection epochs.
One process per device (the GPU unless ``device="cpu"``); bfloat16
convolutions over float32 master weights on the GPU.  Under a process group
(``--coordinator/--num-processes/--process-id``, or torchrun's environment)
the batch splits over the ranks (``parallel/mesh.py``) and rank 0 owns the
run, the logs and the checkpoints.

Run: python -m chessvision_tpu_torch.train.train_unet --epochs 20 ...
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

BOARD_EXTRACTION_PROJECT = "chessvision-segmentation"


def guard_verdict(guard: dict[str, float], baseline: dict[str, float], tolerance: float) -> bool:
    """True when a candidate's geometry did not regress against the
    baseline: mean quadrangle corner error within ``tolerance`` px of the
    starting model's and no more val boards lost."""
    return guard["err"] <= baseline["err"] + tolerance and guard["lost"] <= baseline["lost"]


def train_model(
    *,
    epochs: int = 20,
    batch_size: int = 32,
    learning_rate: float = 3e-5,
    weight_decay: float = 1e-8,
    momentum: float = 0.999,
    gradient_clipping: float = 1.0,
    validations_per_epoch: int = 2,
    run_name: str | None = None,
    run_description: str | None = None,
    use_sample_weights: bool = False,
    collection_frequency: int = 5,
    patience: int = 5,
    threshold: float = 0.5,
    seed: int = 42,
    augment: bool = True,
    aug_illum_gradient: bool = False,
    bilinear: bool = False,
    base: int = 64,
    model_dtype: torch.dtype | None = None,
    use_mesh: bool = True,
    model_id: str = "unet",
    optimizer: str = "rmsprop",
    resume: str | None = None,
    ema_decay: float = 0.0,
    extra_data: list[str] | None = None,
    extra_weight: float = 1.0,
    guard_quad: bool = False,
    guard_tolerance: float = 0.75,
    device: str | torch.device = "cuda",
) -> tuple[Any, str]:
    """Train; returns (run, checkpoint path).  With ``use_mesh`` and a
    process group (``parallel.initialize_distributed``) every rank runs the
    same loop over the same seeded batches and steps on its rows of each;
    the batch size is trimmed to a multiple of the ranks."""
    from chessvision_tpu_torch import models, runstore
    from chessvision_tpu_torch.checkpoint import load_checkpoint, load_metadata, save_checkpoint
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.runstore import metrics as collectors
    from chessvision_tpu_torch.train import data as data_lib
    from chessvision_tpu_torch.train import steps
    from chessvision_tpu_torch.train.augment import augment_segmentation_batch, fold_in

    dev = resolve_device(device)
    if model_dtype is None:
        model_dtype = default_train_dtype(dev)

    # every rank runs the same loop on the same seeded data order; only
    # rank 0 owns the run directory, the logs and the checkpoints
    is_main = mesh_lib.process_index() == 0
    run = runstore.NullRun() if not is_main else runstore.init(
        BOARD_EXTRACTION_PROJECT,
        run_name,
        parameters={
            "epochs": epochs,
            "batch_size": batch_size,
            "learning_rate": learning_rate,
            "use_sample_weights": use_sample_weights,
            "augment": augment,
            "threshold": threshold,
            "seed": seed,
            "bilinear": bilinear,
            "extra_data": list(extra_data or []),
            "extra_weight": extra_weight,
        },
        description=run_description,
    )
    checkpoint_path = str(run.bulk_data_url / "checkpoint.npz")

    data = data_lib.load_board_extraction()
    # extra batches join the TRAIN side only: val stays the real split
    n_extra = 0
    for extra_dir in extra_data or []:
        imgs_e, masks_e, ids_e = data_lib.load_image_mask_dir(extra_dir)
        data.train_images = np.concatenate([data.train_images, imgs_e])
        data.train_masks = np.concatenate([data.train_masks, masks_e])
        data.train_ids = data.train_ids + ids_e
        n_extra += len(ids_e)
        logger.info("Appended %d extra training examples from %s", len(ids_e), extra_dir)
    n_train, n_val = len(data.train_images), len(data.val_images)
    logger.info("Training on %d / validating on %d images", n_train, n_val)

    mesh = None
    if use_mesh and torch.distributed.is_initialized():
        mesh = mesh_lib.create_mesh(device=dev)
        dev = mesh.device
        # equal rows on every rank: the gradient mean is then the global one
        batch_size = max(batch_size, mesh.size)
        batch_size -= batch_size % mesh.size
    else:
        mesh_lib.log_unused_cards(dev, __name__)

    if resume:
        # the architecture comes from the checkpoint; the caller's training
        # hyperparameters still apply
        tc = (load_metadata(resume) or {}).get("training_config", {})
        for name, current in (("model_id", model_id), ("base", base), ("bilinear", bilinear)):
            if name in tc and tc[name] != current:
                logger.warning("resume: adopting %s=%r from checkpoint (requested %r)", name, tc[name], current)
        model_id = tc.get("model_id", model_id)
        base = tc.get("base", base)
        bilinear = tc.get("bilinear", bilinear)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if model_id == "unet":
            model = models.UNet(bilinear=bilinear, base=base)
        else:
            model, _ = models.create_extractor(model_id)
    model = mesh_lib.replicate(mesh, set_compute_dtype(model, model_dtype, master_weights=True).to(dev))
    rng_np = np.random.default_rng(seed)
    aug_key = fold_in(seed, "augment")

    def make_tx(lr: float) -> steps.Transform:
        if optimizer == "adam":
            core = steps.inject_hyperparams(steps.adam, learning_rate=lr)
        else:
            core = steps.inject_hyperparams(steps.rmsprop, learning_rate=lr, momentum=momentum, eps=1e-8)
        return steps.Chain([steps.ClipByGlobalNorm(gradient_clipping), steps.AddDecayedWeights(weight_decay), core])

    state = steps.TrainState.create(model, make_tx(learning_rate))

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

    train_step = steps.make_seg_train_step(mesh)
    eval_step = steps.make_seg_eval_step()
    has_feature_tap = model_id == "unet"

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def put(a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a global batch, on its device."""
        return to_dev(a) if mesh is None else mesh_lib.make_global_batch(mesh, a)

    def collect_step(images: torch.Tensor, masks: torch.Tensor) -> dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            if has_feature_tap:
                out, features = model(images, return_features=True)
            else:
                out = model(images)
                features = torch.mean(out, dim=(1, 2))  # pooled logits
            logits = out[..., 0]
            m: dict[str, torch.Tensor] = {}
            m.update(collectors.segmentation_loss_per_sample(logits, masks))
            m.update(collectors.segmentation_quality(logits, masks, threshold))
            m["embedding"] = features
        return m

    def run_validation() -> float:
        scores, total = [], 0
        for idx in data_lib.batches(n_val, batch_size, drop_last=False):
            idx, real = data_lib.pad_indices(idx, batch_size)
            imgs = put(data.val_images[idx].astype(np.float32) / 255.0)
            msks = put(np.asarray(data.val_masks[idx], np.float32))
            # padded rows repeat the last sample; weight by the real count
            dice = mesh_lib.mean_over_mesh(mesh, eval_step(state, imgs, msks))
            scores.append(float(dice) * real)
            total += real
        return float(np.sum(scores) / total)

    # geometry guard: quadrangle corner error of the model's masks against
    # the ground-truth masks' quads on the val boards
    run_guard = None
    guard_baseline = {"err": float("inf"), "lost": n_val}
    if guard_quad:
        from chessvision_tpu_torch.ops.quad import find_quadrangle_batch

        guard_bs = min(32, max(8, batch_size))
        if mesh is not None:
            guard_bs = max(mesh.size, guard_bs - guard_bs % mesh.size)
        quads_l, founds_l = [], []
        for idx in data_lib.batches(n_val, guard_bs, drop_last=False):
            idx, real = data_lib.pad_indices(idx, guard_bs)
            q, f = find_quadrangle_batch(to_dev(np.asarray(data.val_masks[idx], np.float32)), 0.5)
            quads_l.append(q.cpu().numpy()[:real])
            founds_l.append(f.cpu().numpy()[:real])
        gt_quads, gt_found = np.concatenate(quads_l), np.concatenate(founds_l)
        logger.info("Quad guard: %d/%d val boards have a GT quadrangle", int(gt_found.sum()), n_val)

        def run_guard() -> dict[str, float]:
            """Mean corner L2 (px at the mask size) vs GT quads + boards lost."""
            errs: list[float] = []
            lost = 0
            model.eval()
            for idx in data_lib.batches(n_val, guard_bs, drop_last=False):
                idx, real = data_lib.pad_indices(idx, guard_bs)
                with torch.no_grad():
                    logits = model(put(data.val_images[idx].astype(np.float32) / 255.0))[..., 0].float()
                    q, f = mesh_lib.host_gather(mesh, find_quadrangle_batch(torch.sigmoid(logits), threshold))
                q, f = q[:real], f[:real]
                sel = gt_found[idx[:real]]
                lost += int(np.sum(sel & ~f))
                ok = sel & f
                if ok.any():
                    d = np.linalg.norm(q[ok] - gt_quads[idx[:real]][ok], axis=-1)
                    errs.extend(np.mean(d, axis=-1).tolist())
            return {"err": float(np.mean(errs)) if errs else float("inf"), "lost": lost}

        guard_baseline = run_guard()
        logger.info(
            "Quad guard baseline: corner err %.3f px, %d boards lost", guard_baseline["err"], guard_baseline["lost"]
        )

    collection_epochs = list(range(collection_frequency, epochs + 1, collection_frequency))
    if epochs not in collection_epochs:
        collection_epochs.append(epochs)

    training_config = {
        "epochs": epochs,
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "threshold": threshold,
        "run_name": run.name,
        "model_id": model_id,
        "bilinear": bilinear,
        "base": base,
        "optimizer": optimizer,
    }
    if is_main:
        save_checkpoint(
            checkpoint_path,
            steps.checkpoint_variables(state),
            {"best_val_score": float("-inf"), "training_config": training_config, "epoch": 0},
        )

    weights = None
    if use_sample_weights:
        # curated per-example weights from the dataset table, else a
        # mask-area heuristic
        from chessvision_tpu_torch.train.tables import get_or_create_board_extraction_tables, sample_weights_for_ids

        try:
            tables = get_or_create_board_extraction_tables()
            weights = sample_weights_for_ids(tables["train"], data.train_ids)
        except Exception:  # noqa: BLE001 — the table store is optional for training
            logger.exception("no sample weights from the dataset tables")
            weights = None
        if weights is None:
            weights = data.train_masks.mean(axis=(1, 2)) + 0.05
    if n_extra and extra_weight != 1.0:
        if weights is None:
            weights = np.ones(n_train, np.float64)
        weights = np.asarray(weights, np.float64)
        weights[-n_extra:] *= extra_weight

    # EMA of the parameters, validated and checkpointed beside the raw ones
    ema_params = None
    if ema_decay > 0:
        src = resumed_ema if resumed_ema is not None else [p.detach() for p in state.params]
        ema_params = [t.clone() for t in src]

    steps_per_epoch = max(1, n_train // batch_size)
    validation_interval = max(1, steps_per_epoch // validations_per_epoch)
    best_val_score = float("-inf")
    patience_counter = 0
    plateau_counter = 0
    plateau_best = float("-inf")
    current_lr = learning_rate
    global_step = 0
    val_score = float("-inf")
    start_time = time.time()
    final_epoch = 0

    for epoch in range(start_epoch, epochs + 1):
        final_epoch = epoch
        epoch_loss = 0.0
        for i, idx in enumerate(data_lib.batches(n_train, batch_size, rng=rng_np, weights=weights, drop_last=True)):
            imgs = data.train_images[idx].astype(np.float32) / 255.0
            msks = np.asarray(data.train_masks[idx], np.float32)
            imgs, msks = put(imgs), put(msks)
            if augment:
                # this rank's rows only, with the global batch's draws: the
                # one-process batch's augmentation sliced to them, bit for bit
                imgs, msks = augment_segmentation_batch(
                    fold_in(aug_key, global_step), imgs, msks, illum_gradient=aug_illum_gradient,
                    rows=None if mesh is None else mesh_lib.process_local_batch_slice(len(idx), mesh),
                    global_batch=len(idx),
                )
            metrics = train_step(state, imgs, msks)
            if ema_params is not None:
                ema_params = steps.ema_update(ema_params, state.params, ema_decay)
            global_step += 1
            epoch_loss += metrics["loss"].item()

            if i > 0 and i % validation_interval == 0:
                with steps.params_swapped(state, ema_params):
                    val_score = run_validation()
                if val_score > plateau_best + 1e-6:
                    plateau_best = val_score
                    plateau_counter = 0
                else:
                    plateau_counter += 1
                    if plateau_counter > 3:
                        current_lr *= 0.1
                        state.set_hyperparam("learning_rate", current_lr)
                        plateau_counter = 0
                        logger.info("Plateau: lr -> %g", current_lr)
                run.log({"val_dice": val_score, "step": global_step, "lr": current_lr})
                logger.info("epoch %d step %d val_dice %.4f", epoch, global_step, val_score)

        guard_ok = True
        if run_guard is not None and val_score > best_val_score:
            with steps.params_swapped(state, ema_params):
                g = run_guard()
            guard_ok = guard_verdict(g, guard_baseline, guard_tolerance)
            run.log({"guard_corner_err": g["err"], "guard_lost": g["lost"], "epoch": epoch})
            if not guard_ok:
                logger.warning(
                    "Guard VETO at epoch %d: dice %.4f would be a record but corner err %.3f px "
                    "(baseline %.3f + tol %.2f) / lost %d (baseline %d) regressed — checkpoint NOT saved",
                    epoch, val_score, g["err"], guard_baseline["err"], guard_tolerance, g["lost"],
                    guard_baseline["lost"],
                )
        if val_score > best_val_score and guard_ok:
            best_val_score = val_score
            patience_counter = 0
            # raw params stay paired with the optimizer state; the EMA view
            # is stored separately under "ema_params"
            if is_main:
                save_checkpoint(
                    checkpoint_path,
                    steps.checkpoint_variables(state, ema_params),
                    {"best_val_score": best_val_score, "epoch": epoch, "training_config": training_config},
                    opt_state=state.opt_state_leaves(),
                )
                logger.info("Checkpoint %d saved (dice %.4f)", epoch, best_val_score)
        else:
            patience_counter += 1

        run.log({"train_loss": epoch_loss / steps_per_epoch, "epoch": epoch})

        if epoch in collection_epochs and mesh_lib.spans_processes(mesh):
            # per-sample collection is a host-side curation pass of one
            # process; a multi-process run skips it, as the JAX trainer does
            logger.info("Skipping metrics collection (multi-process mesh)")
        elif epoch in collection_epochs:
            for split, imgs_a, msks_a, ids in (
                ("train", data.train_images, data.train_masks, data.train_ids),
                ("val", data.val_images, data.val_masks, data.val_ids),
            ):
                rows: dict[str, list] = {}
                for idx in data_lib.batches(len(imgs_a), 8):
                    idx, real = data_lib.pad_indices(idx, 8)
                    m = collect_step(to_dev(imgs_a[idx].astype(np.float32) / 255.0), to_dev(np.asarray(msks_a[idx])))
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
            "best_val_score": best_val_score,
            "model_path": checkpoint_path,
            "final_epoch": final_epoch,
            "training_time": training_time,
        }
    )
    run.set_status_completed()
    logger.info("Training done in %.0fs, best dice %.4f", training_time, best_val_score)
    return run, checkpoint_path


def get_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the UNet board extractor (PyTorch)")
    parser.add_argument("--run-name", type=str, default=None)
    parser.add_argument("--run-description", type=str, default=None)
    parser.add_argument("--skip-eval", action="store_true")
    parser.add_argument("--use-sample-weights", action="store_true")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=3e-5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--collection-frequency", type=int, default=5)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--bilinear", action="store_true", default=False)
    parser.add_argument("--ema-decay", type=float, default=0.0, help="validate/checkpoint an EMA of params (0 = off)")
    parser.add_argument("--base", type=int, default=64)
    parser.add_argument("--no-augment", action="store_true", default=False)
    parser.add_argument("--aug-illum-gradient", action="store_true", help="page-gutter illumination-gradient augmentation")
    parser.add_argument("--model-id", type=str, default="unet", help="unet or yolo")
    parser.add_argument("--optimizer", type=str, default="rmsprop", choices=["rmsprop", "adam"])
    parser.add_argument("--resume", type=str, default=None, help="checkpoint to resume from (either package's)")
    parser.add_argument("--extra-data", action="append", default=None, help="images/+masks/ dir appended to the TRAIN split (repeatable)")
    parser.add_argument("--extra-weight", type=float, default=1.0, help="relative sampling weight of --extra-data examples")
    parser.add_argument("--guard-quad", action="store_true", help="refuse checkpoints whose val quadrangle corner error regresses")
    parser.add_argument("--guard-tolerance", type=float, default=0.75, help="allowed mean corner-error regression in px")
    parser.add_argument("--promote", action="store_true", help="copy best checkpoint to weights/")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--coordinator", type=str, default=None, help="multi-process: coordinator host:port (tcp://)")
    parser.add_argument("--num-processes", type=int, default=None, help="multi-process: process count")
    parser.add_argument("--process-id", type=int, default=None, help="multi-process: this process's rank")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = get_args(argv)
    setup_logger("chessvision_tpu_torch")
    # join the process group before the trainer looks for it (explicit
    # flags or torchrun's environment; one plain process is a no-op)
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
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        run_name=args.run_name,
        run_description=args.run_description,
        use_sample_weights=args.use_sample_weights,
        collection_frequency=args.collection_frequency,
        patience=args.patience,
        threshold=args.threshold,
        seed=args.seed,
        augment=not args.no_augment,
        aug_illum_gradient=args.aug_illum_gradient,
        bilinear=args.bilinear,
        base=args.base,
        model_id=args.model_id,
        optimizer=args.optimizer,
        resume=args.resume,
        ema_decay=args.ema_decay,
        extra_data=args.extra_data,
        extra_weight=args.extra_weight,
        guard_quad=args.guard_quad,
        guard_tolerance=args.guard_tolerance,
        device=args.device,
    )
    if mesh_lib.process_index() != 0:
        return  # promotion and evaluation are rank 0's
    from pathlib import Path

    from chessvision_tpu_torch.checkpoint import promote_checkpoint

    default = constants.BEST_YOLO_EXTRACTOR if args.model_id == "yolo" else constants.BEST_EXTRACTOR_WEIGHTS
    if args.promote or not Path(default).exists():
        promote_checkpoint(checkpoint_path, default)
        logger.info("Promoted checkpoint to %s", default)

    if not args.skip_eval:
        from chessvision_tpu_torch.eval.evaluate import evaluate_model

        evaluate_model(
            run=run,
            threshold=args.threshold,
            board_extractor_weights=checkpoint_path,
            board_extractor_model_id=None if args.model_id == "unet" else args.model_id,
            device=args.device,
        )


if __name__ == "__main__":
    main()
