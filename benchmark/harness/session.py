"""A run of one cell: set-up, the measured window or the traced slice, the
check against the reference, and the result line."""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from types import SimpleNamespace
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from benchmark.counts import peaks as peaks_mod
from benchmark.harness import check, frames, loop, spec, weights
from benchmark.harness import trace as trace_mod
from benchmark.reference.pipeline import Reference

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "chessvision_tpu"})


def forbidden_modules(names: Iterable[str] | None = None) -> list[str]:
    """Top-level names of loaded modules (of ``names``) that the benchmark
    may not load, compared whole: ``chessvision_tpu_torch`` is not
    ``chessvision_tpu``."""
    loaded = list(sys.modules) if names is None else names
    return sorted({name.split(".", 1)[0] for name in loaded} & FORBIDDEN)


def make_inputs(traffic: dict, seed: int, device: torch.device) -> list[np.ndarray]:
    """The mix's distinct inputs as host uint8 arrays: ``count`` frames of
    the listed sizes in turn, grouped into requests of ``batch`` frames
    (a batch of one is a single photo, without the batch axis)."""
    f = traffic["frames"]
    sizes = [tuple(s) for s in f["sizes"]]
    per = f["batch"]
    out = []
    for r in range(f["count"] // per):
        shapes = [sizes[(r * per + j) % len(sizes)] for j in range(per)]
        batch = frames.scenes((seed % (1 << 64)) * 1_000_003 + r, shapes, f["texture"], device)
        out.append(batch[0].cpu().numpy() if per == 1 else torch.stack(batch).cpu().numpy())
        del batch
    return out


def input_on(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(x).to(device)
    return t if t.ndim == 4 else t[None]


@contextlib.contextmanager
def patched(targets: list[tuple[Any, str, str]], wrap: Callable[[str, Callable], Callable]) -> Iterator[None]:
    """Replace each ``owner.attr`` by ``wrap(label, original)`` inside the
    block."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    try:
        for (owner, attr, fn), (_, _, label) in zip(saved, targets):
            setattr(owner, attr, wrap(label, fn))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def layer_targets(cv: Any) -> list[tuple[Any, str, str]]:
    """The calls into each layer of the port that the traced run wraps in a
    span: (owner, attribute, layer label)."""
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.ops import gridfix

    engine = cv.engine
    return [
        (engine, "_on_device", "upload"),
        (engine_mod, "preprocess_images", "front"),
        (engine, "_extractor", "extractor"),
        (engine_mod, "find_quadrangle_batch", "quad"),
        (engine_mod, "warp_perspective", "warp"),
        (gridfix, "detect_grid", "gridfix"),
        (engine_mod, "_arbitrate_chunk", "arbitrate"),
        (engine_mod, "_copy_back", "copy_back"),
        (engine_mod, "_binary_mask", "mask"),
        (engine_mod, "validate_labels_batch", "validate"),
        (engine_mod, "_fen_strings", "fen"),
    ]


def _span(label: str, fn: Callable) -> Callable:
    name = trace_mod.SPAN_PREFIX + label

    def run(*a: Any, **k: Any) -> Any:
        with torch.profiler.record_function(name):
            return fn(*a, **k)

    return run


def sync(device: torch.device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synced_timer(acc: dict[str, list[float]], device: torch.device) -> Callable[[str, Callable], Callable]:
    def wrap(label: str, fn: Callable) -> Callable:
        def run(*a: Any, **k: Any) -> Any:
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(device)
            acc.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
            return out

        return run

    return wrap


def warm_up(entry: loop.Entry, traffic: dict, device: torch.device) -> None:
    """Every input the cell sends, ``warmup_rounds`` times, then a device
    synchronize: every shape and every kernel the window uses is built and
    loaded before it opens."""
    n = len(entry.inputs) * traffic["warmup_rounds"]
    loop.closed_loop(entry, None, n, loop.Reservoir(0, np.random.default_rng(0)))
    entry.close()
    sync(device)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float) -> tuple[dict, list[str]]:
    """Run ``cell`` once; returns (result, the check lines)."""
    traffic, config = cell.traffic, cell.config
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    seeded = weights.make(config, seed, device)
    cv = loop.build(config, spec.ROOT, device, seeded)
    inputs = make_inputs(traffic, seed, device)
    entry = spec.entry(traffic["entry"])(cv, inputs, float(config["engine"]["threshold"]), traffic)
    warm_up(entry, traffic, device)
    keep = loop.Reservoir(traffic["retain"], np.random.default_rng([seed % (1 << 64), 1]))
    gc.collect()
    window_open = time.perf_counter()
    setup_s = window_open - t_start
    slice_info: dict[str, Any] = {}
    if not traced:
        window = loop.closed_loop(entry, seconds, None, keep)
        entry.close()
        attempted, failed = window["attempted"], window["failed"]
    else:
        n = traffic["trace_requests"]
        activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with patched(layer_targets(cv), _span), torch.profiler.profile(activities=activities) as prof:
            done = [0]

            def request(call: Callable) -> Any:
                # the last request ends when the device is done; the others
                # overlap as they do in the window
                with torch.profiler.record_function(trace_mod.REQUEST_SPAN):
                    out = call()
                    done[0] += 1
                    if done[0] == n:
                        sync(device)
                return out

            sliced = loop.closed_loop(entry, None, n, keep, wrap=request)
            entry.close()
        synced: dict[str, list[float]] = {}
        quad_target = [t for t in layer_targets(cv) if t[2] == "quad"]
        with patched(quad_target, _synced_timer(synced, device)):
            timed = loop.closed_loop(entry, None, n, keep, start=n)
            entry.close()
        attempted = sliced["attempted"] + timed["attempted"]
        failed = sliced["failed"] + timed["failed"]
        slice_info = {"prof": prof, "sliced": sliced, "synced": synced, "timed": timed}
    sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    kept = [(k, entry.to_host(out)) for k, out in keep.kept]
    del keep, entry, cv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = Reference(config, spec.ROOT, device, seeded=seeded)
    judge = spec.check(traffic["check"]).Judge(reference)
    for k, out in kept:
        judge.add(k, input_on(inputs[k], device), out)
    readings = judge.readings()
    ok, checks = check.verdict(readings, cell.limits)
    correct = ok and failed == 0 and attempted > 0

    dev_info: dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    dev_info["power_limit_w"] = peaks_mod.power_limit_w(device.index or 0) if cuda else None
    result: dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": failed}
    if not traced:
        win = SimpleNamespace(**window, seconds=window["end"] - window["begin"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": spec.end_to_end(m["name"]).read(win), "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        tdata = trace_mod.from_profiler(slice_info["prof"], slice_info["sliced"]["attempted"],
                                        slice_info["sliced"]["boards"])
        ctx = Context(cell, reference, judge, inputs, tdata, slice_info, device, dev_info["kind"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        dev_info["busy_s"] = tdata.busy_s
        dev_info["window_s"] = tdata.window_s
        result["breakdown"] = tdata.breakdown()
    result["device"] = dev_info
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    lines.append(f"correct: {correct} (attempted {attempted}, failed {failed})")
    return result, lines


class Context:
    """What a per-layer reader reads: the profiled slice (``trace``), the
    synchronised host timings of the second slice (``synced_ms``), and the
    counts of work from shapes (``flops_per_board``, ``k1_floor_bytes``,
    ``bn_act_bytes``) with the card's ``peaks``."""

    def __init__(self, cell: spec.Cell, reference: Any, judge: Any, inputs: list[np.ndarray],
                 tdata: trace_mod.TraceData, info: dict, device: torch.device, kind: str) -> None:
        self.cell = cell
        self.trace = tdata
        self.synced_ms = info["synced"]
        self.synced_requests = info["timed"]["attempted"]
        self.peaks = peaks_mod.PEAKS.get(kind)
        self._ref, self._judge, self._inputs, self._device = reference, judge, inputs, device
        self._keys = [i % len(inputs) for i in range(info["sliced"]["attempted"])]

    def _shapes(self) -> list[tuple[int, int]]:
        return [self._inputs[k].shape[-3:-1] for k in self._keys]

    def flops_per_board(self) -> float:
        """Mean FLOPs a board over the slice's frames."""
        from benchmark.counts import flops

        cache: dict[tuple[int, int], float] = {}
        per = []
        for hw in self._shapes():
            if hw not in cache:
                cache[hw] = flops.pipeline_flops_per_board(self._ref, *hw)
            per.append(cache[hw])
        return float(np.mean(per))

    def k1_floor_bytes(self) -> float:
        """K1's floor in bytes over every board of the slice."""
        from benchmark.counts import k1_bytes

        canvas = 512 + 2 * int(self.cell.config["engine"]["refine_margin"])
        per_input: dict[int, int] = {}
        for k in set(self._keys):
            frames_dev = input_on(self._inputs[k], self._device)
            ms_wide = self._ref.wide_homographies(frames_dev, self._judge.seg(k, frames_dev))
            per_input[k] = k1_bytes.warp_floor_bytes(tuple(frames_dev.shape[1:3]), ms_wide, canvas)
        return float(sum(per_input[k] for k in self._keys))

    def bn_act_bytes(self) -> float:
        """``bn_act``'s bytes over every board of the slice."""
        from benchmark.counts import bn_bytes

        return bn_bytes.bn_act_bytes_per_board(self._ref, self.cell.config["dtype"]) * self.trace.boards


def dumps(result: dict) -> str:
    return json.dumps(result, separators=(", ", ": "))
