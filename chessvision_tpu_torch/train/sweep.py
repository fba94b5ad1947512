"""Hyperparameter sweep runner and parallel-coordinates report, the
counterpart of ``chessvision_tpu/train/sweep.py``: a grid over the port's
trainers, the runs' parameters read back from ``runstore``, and the plot
drawn with cv2 (the GPU machine has cv2 and no matplotlib, as for
``eval/render.py``; the JAX package plots with matplotlib).

Run: python -m chessvision_tpu_torch.train.sweep --target unet --epochs 2 ...
"""

from __future__ import annotations

import argparse
import itertools
import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from chessvision_tpu_torch.runstore.runs import Run, list_runs
from chessvision_tpu_torch.runstore.tables import store_root

logger = logging.getLogger(__name__)

_DIMS = ["learning_rate", "threshold", "use_sample_weights", "best_val_score"]


def run_sweep(
    target: str = "unet",
    learning_rates: Sequence[float] = (1e-5, 3e-5, 1e-4),
    thresholds: Sequence[float] = (0.3, 0.5, 0.7),
    sample_weights: Sequence[bool] = (False, True),
    epochs: int = 5,
    sweep_id: int = 0,
    **kwargs: Any,
) -> list[Run]:
    """Grid sweep over the segmentation or classification trainer; extra
    keyword arguments (``device``, ``base``, …) go to ``train_model``."""
    runs: list[Run] = []
    if target == "unet":
        from chessvision_tpu_torch.train.train_unet import train_model

        grid = list(itertools.product(learning_rates, thresholds, sample_weights))
        for i, (lr, thr, sw) in enumerate(grid):
            name = f"sweep{sweep_id}-{i:03d}-lr{lr:g}-thr{thr:g}-sw{int(sw)}"
            logger.info("Sweep %d/%d: %s", i + 1, len(grid), name)
            run, _ = train_model(
                epochs=epochs, learning_rate=lr, threshold=thr, use_sample_weights=sw, run_name=name, **kwargs
            )
            run.set_parameters({"sweep_id": sweep_id})
            runs.append(run)
    elif target == "classifier":
        from chessvision_tpu_torch.train.train_classifier import train_model as train_cls

        for i, (lr, sw) in enumerate(itertools.product(learning_rates, sample_weights)):
            name = f"sweep{sweep_id}-{i:03d}-lr{lr:g}-sw{int(sw)}"
            run, _ = train_cls(epochs=epochs, learning_rate=lr, use_sample_weights=sw, run_name=name, **kwargs)
            run.set_parameters({"sweep_id": sweep_id})
            runs.append(run)
    else:
        raise ValueError(f"unknown sweep target {target}")
    return runs


def collect_sweep_data(project: str, sweep_id: int | None = None) -> list[dict[str, Any]]:
    """The runs' parameters of a sweep, one row a run."""
    rows = []
    for name in list_runs(project):
        p = Run(project, name).parameters
        if sweep_id is not None and p.get("sweep_id") != sweep_id:
            continue
        rows.append({"run": name, **{d: p.get(d) for d in _DIMS}})
    return rows


def _viridis(t: float) -> tuple[int, int, int]:
    """A BGR color on viridis's path (5 stops, linear between them)."""
    stops = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]], np.float64)
    x = float(np.clip(t, 0.0, 1.0)) * (len(stops) - 1)
    i = min(int(x), len(stops) - 2)
    r, g, b = stops[i] + (stops[i + 1] - stops[i]) * (x - i)
    return int(round(b)), int(round(g)), int(round(r))


def plot_sweep(project: str, sweep_id: int | None = None, out_path: str | None = None) -> str:
    """Parallel-coordinates plot of a sweep's results as a PNG: one axis a
    dimension (min at the bottom, max at the top), one line a run,
    colored by its best validation score."""
    import cv2

    rows = [r for r in collect_sweep_data(project, sweep_id) if r["best_val_score"] is not None]
    if not rows:
        raise ValueError("no sweep runs found")
    data = np.array([[float(r[d]) if r[d] is not None else np.nan for d in _DIMS] for r in rows], float)
    # drop the dimensions this sweep lacks (e.g. threshold for classifiers)
    keep = [i for i in range(len(_DIMS)) if not np.isnan(data[:, i]).all()]
    dims = [_DIMS[i] for i in keep]
    data = data[:, keep]
    mins, maxs = np.nanmin(data, axis=0), np.nanmax(data, axis=0)
    span = np.where(maxs - mins == 0, 1, maxs - mins)
    norm = (data - mins) / span

    w, h, pad = 1200, 600, 90
    img = np.full((h, w, 3), 255, np.uint8)
    xs = [int(pad + i * (w - 2 * pad) / max(1, len(dims) - 1)) for i in range(len(dims))]
    top, bottom = pad, h - pad
    font = cv2.FONT_HERSHEY_SIMPLEX
    for x, d, lo, hi in zip(xs, dims, mins, maxs):
        cv2.line(img, (x, top), (x, bottom), (80, 80, 80), 1, cv2.LINE_AA)
        cv2.putText(img, d, (x - 60, bottom + 40), font, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
        cv2.putText(img, f"{lo:g}", (x - 20, bottom + 18), font, 0.4, (0, 0, 0), 1, cv2.LINE_AA)
        cv2.putText(img, f"{hi:g}", (x - 20, top - 8), font, 0.4, (0, 0, 0), 1, cv2.LINE_AA)
    scores = data[:, -1]
    smin, smax = np.nanmin(scores), np.nanmax(scores)
    for i in range(len(rows)):
        pts = [(x, int(round(bottom - v * (bottom - top)))) for x, v in zip(xs, norm[i]) if np.isfinite(v)]
        color = _viridis((scores[i] - smin) / (smax - smin + 1e-12))
        cv2.polylines(img, [np.array(pts, np.int32)], False, color, 2, cv2.LINE_AA)
    title = f"Sweep results: {project}" + (f" (sweep {sweep_id})" if sweep_id is not None else "")
    cv2.putText(img, title, (pad, 40), font, 0.7, (0, 0, 0), 2, cv2.LINE_AA)
    out = out_path or str(store_root() / "projects" / project / f"sweep_{sweep_id or 'all'}.png")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(out, img)
    logger.info("Sweep plot written to %s", out)
    return out


def main(argv: list[str] | None = None) -> None:
    from chessvision_tpu_torch.utils import setup_logger

    parser = argparse.ArgumentParser()
    parser.add_argument("--target", default="unet", choices=["unet", "classifier"])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--sweep-id", type=int, default=0)
    parser.add_argument("--learning-rates", type=float, nargs="+", default=[1e-5, 3e-5, 1e-4])
    parser.add_argument("--thresholds", type=float, nargs="+", default=[0.3, 0.5, 0.7])
    parser.add_argument("--plot-only", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    setup_logger("chessvision_tpu_torch")
    project = "chessvision-segmentation" if args.target == "unet" else "chessvision-classification"
    if not args.plot_only:
        run_sweep(
            target=args.target,
            epochs=args.epochs,
            sweep_id=args.sweep_id,
            learning_rates=args.learning_rates,
            thresholds=args.thresholds,
            device=args.device,
        )
    plot_sweep(project, args.sweep_id)


if __name__ == "__main__":
    main()
