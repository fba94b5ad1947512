"""Shared set-up of the trainer parity tests (tests/test_torch_trainers*.py):
tiny seeded datasets in both packages' dataclasses, initial checkpoints
written by the JAX package, and the comparisons of two runs."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def seg_data(data_mod):
    """16 train / 4 val 64² boards: blocky color images, one rectangular
    board mask each."""
    rng = np.random.default_rng(123)
    n = 20
    imgs = np.repeat(np.repeat(rng.integers(0, 256, (n, 8, 8, 3), np.uint8), 8, 1), 8, 2)
    masks = np.zeros((n, 64, 64), np.float32)
    for i in range(n):
        y0, x0 = rng.integers(4, 16, 2)
        y1, x1 = rng.integers(44, 60, 2)
        masks[i, y0:y1, x0:x1] = 1.0
        imgs[i, y0:y1, x0:x1] = imgs[i, y0:y1, x0:x1] // 2 + 100
    return data_mod.SegmentationData(
        imgs[:16], masks[:16], imgs[16:], masks[16:], [f"t{i}" for i in range(16)], [f"v{i}" for i in range(4)]
    )


def cls_data(data_mod):
    """16 train / 13 val 64² squares, one val square per class."""
    rng = np.random.default_rng(7)
    tr_y = (np.arange(16) % 13).astype(np.int32)
    va_y = np.arange(13).astype(np.int32)

    def squares(labels):
        base = rng.integers(0, 256, (len(labels), 8, 8), np.uint8)
        img = np.repeat(np.repeat(base, 8, 1), 8, 2)
        img[:, 20:44, 20:44] = (labels[:, None, None] * 19).astype(np.uint8)
        return img

    names = [str(i) for i in range(13)]
    return data_mod.ClassificationData(
        squares(tr_y), tr_y, squares(va_y), va_y, [f"t{i}" for i in range(16)], [f"v{i}" for i in range(13)], names
    )


def unet_init_checkpoint(path: Path) -> str:
    import jax
    import jax.numpy as jnp

    from chessvision_tpu import models
    from chessvision_tpu.checkpoint import save_checkpoint

    v = jax.jit(models.UNet(base=4, dtype=jnp.float32).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    save_checkpoint(
        path,
        {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": jax.tree.map(np.asarray, v["batch_stats"])},
        {"epoch": 0, "training_config": {"model_id": "unet", "base": 4, "bilinear": False}},
    )
    return str(path)


def cls_init_checkpoint(path: Path) -> str:
    import jax
    import jax.numpy as jnp

    from chessvision_tpu import models
    from chessvision_tpu.checkpoint import save_checkpoint

    v = jax.jit(models.resnet18(width=8, dtype=jnp.float32).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    save_checkpoint(
        path,
        {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": jax.tree.map(np.asarray, v["batch_stats"])},
        {"epoch": 0, "training_config": {"model_id": "resnet18", "width": 8}},
    )
    return str(path)


def flat_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict]:
    from chessvision_tpu.checkpoint import _flatten, load_checkpoint

    variables, meta = load_checkpoint(path)
    return _flatten(variables), meta


def checkpoint_errors(path_a: str, path_b: str) -> dict[str, float]:
    """Two checkpoints with the same keys, shapes and dtypes: the largest
    difference over each group relative to that group's largest magnitude
    (``params``, ``ema_params``, ``opt_state``), and per leaf for
    ``batch_stats``."""
    a, meta_a = flat_checkpoint(path_a)
    b, meta_b = flat_checkpoint(path_b)
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    assert meta_a["epoch"] == meta_b["epoch"]
    errs = {}
    for group in ("params", "ema_params", "opt_state"):
        keys = [k for k in a if k.split("/")[0] == group]
        if keys:
            diff = max(float(np.max(np.abs(a[k].astype(np.float64) - b[k]))) for k in keys)
            errs[group] = diff / max(float(np.max(np.abs(a[k]))) for k in keys)
    errs["batch_stats"] = max(
        float(np.max(np.abs(a[k].astype(np.float64) - b[k])) / (np.max(np.abs(a[k])) + 1e-30))
        for k in a if k.startswith("batch_stats/")
    )
    return errs


def scalar_errors(run_a, run_b) -> float:
    """Same logged keys in the same order; the largest relative difference
    of the logged numbers (step and epoch counters must be equal)."""
    sa, sb = run_a.scalars(), run_b.scalars()
    assert [sorted(x) for x in sa] == [sorted(x) for x in sb], (sa, sb)
    worst = 0.0
    for x, y in zip(sa, sb):
        for k in x:
            if k in ("step", "epoch", "guard_lost"):
                assert x[k] == y[k], (k, x, y)
            elif x[k] != y[k]:  # equal covers inf (a guard with no board found)
                worst = max(worst, abs(x[k] - y[k]) / max(abs(x[k]), 1e-12))
    return worst


def metrics_table_errors(run_a, run_b, name: str) -> dict[str, float]:
    """Per-sample columns of two runs' metrics tables: ids equal, the
    largest absolute difference per numeric column; the 2-D PCA embedding
    compared after aligning each component's sign."""
    ta, tb = run_a.read_metrics_table(name), run_b.read_metrics_table(name)
    assert ta.keys() == tb.keys()
    assert list(ta["example_id"]) == list(tb["example_id"])
    errs = {}
    for k in ta:
        if k == "example_id":
            continue
        a, b = np.asarray(ta[k], np.float64), np.asarray(tb[k], np.float64)
        if k.endswith("_2d"):
            b = b * np.sign(np.sum(a * b, axis=0, keepdims=True))
        errs[k] = float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(a))), 1e-12)
    return errs
