"""The system under test and the closed loop that drives it.

``build`` makes the port's facade from a configuration file.  An
``Entry`` (one a file, ``entries/<name>.py``, named by the traffic mix)
calls one of the facade's entry points the way its users do, one request
at a time, and hands back what the call returned for the comparison with
the reference; ``closed_loop`` sends the requests one after the other (a
closed loop with one caller) and ``Reservoir`` keeps a sample of their
outputs drawn from the seed.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

SLOTS = {"extractor": "_board_extractor", "classifier": "_classifier"}


def _seeded_model(kind: str, model: dict, flat: dict[str, np.ndarray], dtype: torch.dtype,
                  device: torch.device) -> tuple[Any, Any]:
    """The port's model of ``model`` (its id and architecture) holding the
    seeded leaves ``flat``, loaded as the port loads a checkpoint's."""
    from chessvision_tpu_torch import models
    from chessvision_tpu_torch import weights as weights_mod
    from chessvision_tpu_torch.models.layers import set_compute_dtype

    create = models.create_extractor if kind == "extractor" else models.create_classifier
    with torch.device(device):
        module, spec = create(model["model_id"], **model["arch"])
    tree: dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    module.load_state_dict(weights_mod.flax_to_torch(tree, module))
    return set_compute_dtype(module, dtype).eval(), spec


def build(config: dict, root: Path, device: torch.device, seeded: dict[str, dict] | None = None) -> Any:
    """The port's ``ChessVision`` for ``config``, its models loaded (a
    checkpoint file, or for ``"weights": "seeded"`` the leaves in
    ``seeded[kind]``, ``harness/weights.py``) and its engine built; raises
    where the engine would run otherwise than the configuration states."""
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision

    models, eng = config["models"], config["engine"]
    ex, cl = models["extractor"], models["classifier"]
    dtype = getattr(torch, config["dtype"])
    cv = ChessVision(
        board_extractor_weights=None if ex["weights"] == "seeded" else str(root / ex["weights"]),
        board_extractor_model_id=ex["model_id"],
        classifier_weights=None if cl["weights"] == "seeded" else str(root / cl["weights"]),
        classifier_model_id=cl["model_id"],
        dtype=dtype,
        device=device,
        refine_grid=eng["refine"],
    )
    for kind, slot in SLOTS.items():
        if models[kind]["weights"] == "seeded":
            # the facade's lazy model slot, filled before the engine is built
            setattr(cv, slot, _seeded_model(kind, models[kind], seeded[kind], dtype, device))
    engine = cv.engine
    stated = {"refine_margin": engine_mod._REFINE_MARGIN, "arbitrate_chunk": engine._arbitrate_chunk,
              "refine": engine._refine}
    for key, value in stated.items():
        if value != eng[key]:
            raise RuntimeError(f"the engine runs {key}={value!r}; the configuration states {eng[key]!r}")
    return cv


class Entry:
    """One entry point over a list of distinct host inputs, cycled."""

    boards_per_request = 1

    def __init__(self, cv: Any, inputs: list[np.ndarray], threshold: float, traffic: dict) -> None:
        self.cv = cv
        self.inputs = inputs
        self.threshold = threshold
        self.traffic = traffic

    def requests(self, start: int) -> Iterator[tuple[int, Callable[[], dict[str, Any]]]]:
        """Endless (input index, call) pairs from request ``start`` on; each
        call runs one request and returns its outputs."""
        raise NotImplementedError

    def close(self) -> None:
        """End whatever the entry keeps open between requests."""

    def to_host(self, out: dict[str, Any]) -> dict[str, Any]:
        """A retained output as host arrays, once the window has closed."""
        return out


class Reservoir:
    """A uniform sample of ``k`` of the requests seen, drawn from the seed
    (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self.k = k
        self.rng = rng
        self.seen = 0
        self.kept: list[tuple[int, dict[str, Any]]] = []

    def offer(self, key: int, out: dict[str, Any]) -> None:
        if len(self.kept) < self.k:
            self.kept.append((key, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (key, out)
        self.seen += 1


def closed_loop(
    entry: Entry, seconds: float | None, count: int | None, keep: Reservoir, start: int = 0,
    wrap: Callable[[Callable[[], Any]], Any] | None = None,
) -> dict[str, Any]:
    """Requests one after the other until ``seconds`` have passed (a request
    that started in time runs to its end) or ``count`` are done.  Returns
    the window's start and end on the host clock, each request's latency
    and boards, and the failures."""
    lat: list[float] = []
    boards = attempted = failed = 0
    t_begin = time.perf_counter()
    deadline = None if seconds is None else t_begin + seconds
    t_end = t_begin
    for key, call in entry.requests(start):
        t0 = time.perf_counter()
        if (deadline is not None and t0 >= deadline) or (count is not None and attempted >= count):
            break
        attempted += 1
        try:
            out = wrap(call) if wrap is not None else call()
        except Exception:  # a request that never comes back counts as failed; the window goes on
            failed += 1
            print(f"request {attempted - 1} failed:", file=sys.stderr)
            traceback.print_exc()
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        boards += entry.boards_per_request
        keep.offer(key, out)
    return {"begin": t_begin, "end": t_end, "latency_s": lat, "boards": boards,
            "attempted": attempted, "failed": failed}
