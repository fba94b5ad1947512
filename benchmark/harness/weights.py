"""Seeded weights for a configuration's ``"weights": "seeded"`` models,
made on the device in one draw a model and handed, the same arrays, to
the program (``loop.build``) and to the reference.

Every leaf of the architecture (its ``leaves``, ``reference.models.arch``) is cut from
one standard normal draw of a ``torch.Generator`` on the device: kernels
scaled by √(2 / fan-in), as He's initialisation keeps the activations'
scale through ReLU layers, and convolution kernels rounded to the dtype
the configuration serves them in; BatchNorm scales and variances near 1,
biases and means near 0, so the running statistics do real work.  A
model's ``held`` leaves (its configuration's) are set to the value given,
where the draw would otherwise change the work from seed to seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import models

KINDS = ("extractor", "classifier")


def _leaves(shapes: dict[str, tuple[int, ...]], seed: int, dtype: torch.dtype, device: torch.device,
            held: dict[str, float]) -> dict[str, np.ndarray]:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    z = torch.randn(sum(sizes), generator=g, device=device)
    parts = []
    for name, chunk in zip(names, z.split(sizes)):
        shape, leaf = shapes[name], name.rsplit("/", 1)[1]
        if leaf == "kernel":
            chunk = chunk * math.sqrt(2.0 / math.prod(shape[:-1]))
            if len(shape) == 4:  # a convolution's, served in the configuration's dtype
                chunk = chunk.to(dtype).float()
        elif leaf in ("scale", "var"):
            chunk = 1.0 + 0.1 * chunk.abs() if leaf == "var" else 1.0 + 0.1 * chunk
        else:  # bias, mean
            chunk = 0.1 * chunk
        if name in held:
            chunk = torch.full_like(chunk, held[name])
        parts.append(chunk)
    host = torch.cat(parts).cpu().numpy()
    return {n: a.reshape(shapes[n]) for n, a in zip(names, np.split(host, np.cumsum(sizes)[:-1]))}


def make(config: dict, seed: int, device: torch.device) -> dict[str, dict[str, np.ndarray]]:
    """{kind: flat leaves} for each seeded model of ``config`` (none for a
    model read from a checkpoint)."""
    dtype = getattr(torch, config["dtype"])
    out = {}
    for i, kind in enumerate(KINDS):
        model = config["models"][kind]
        if model["weights"] != "seeded":
            continue
        shapes = models.arch(model["model_id"]).leaves(**model["arch"])
        sub = int(np.random.SeedSequence([seed % (1 << 64), i]).generate_state(1, np.uint64)[0] % (1 << 63))
        out[kind] = _leaves(shapes, sub, dtype, device, model.get("held", {}))
    return out
