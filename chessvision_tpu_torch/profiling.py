"""Tracing and timing utilities of the port (counterpart of
``chessvision_tpu/profiling.py``).

``span`` is the port's one way to mark a stage: the engine and the facade
open a ``cv:<stage>`` span at each stage boundary, which a running
``torch.profiler`` records on its own clock beside the device's events and
which costs about a microsecond when nothing records.  ``trace`` captures a
``torch.profiler`` trace around any region and writes it as a Chrome trace
(Perfetto reads it, spans included); ``time_fn`` is a synchronized
wall-clock timer; ``profile_engine_stages`` times the pipeline's stages one
at a time.  ``stage_breakdown`` (the spans' host self times),
``device_busy`` and ``upload_overlap`` take apart one
``Engine.process_batch`` / ``run_stream`` call.  On the GPU every timed
call ends in ``torch.cuda.synchronize``: PyTorch returns before the device
has finished, so a host clock without one measures the enqueue.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.ops.color import bgr_to_gray, hflip
from chessvision_tpu_torch.ops.quad import find_quadrangle_batch
from chessvision_tpu_torch.ops.resize import resize
from chessvision_tpu_torch.ops.squares import extract_squares_batch
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.parallel import mesh as mesh_lib
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.utils import full_f32

SPAN_PREFIX = "cv:"

# torch.profiler.record_function costs about ten microseconds a span even
# with no profiler running, and it records a user annotation, which Kineto
# mirrors onto the device's timeline, where a trace reader would count it
# as device work.  The private _RecordFunctionFast records a plain cpu_op
# on the profiler's clock, puts nothing on the device's timeline and
# launches nothing, and costs under a microsecond when nothing records.
# This is the port's one use of it: a torch upgrade that moves it touches
# only this line.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str) -> Any:
    """A context manager that marks the enclosed host work as the span
    ``cv:<name>`` while a ``torch.profiler`` records (``trace`` writes it
    out with the rest); it does nothing else."""
    return _RecordFunctionFast(SPAN_PREFIX + name)


def _sync(device: torch.device | None = None) -> None:
    """Wait for ``device``'s work; by default this process's card
    (``cuda:LOCAL_RANK``), never whichever card happens to be current."""
    dev = mesh_lib.local_device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def _profiler() -> Any:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None) -> Iterator[Any]:
    """Capture a torch.profiler trace of the enclosed region (host ops, and
    device kernels and copies where there is a GPU) and write it to
    ``log_dir/trace.json`` (default: ``cvtorch_trace`` in the temporary
    directory).  Yields the profiler."""
    out = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "cvtorch_trace"
    out.mkdir(parents=True, exist_ok=True)
    with _profiler() as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(out / "trace.json"))


def wall_ms(
    fn: Callable[..., Any], *args: Any, iters: int = 10, warmup: int = 0, device: torch.device | None = None
) -> list[float]:
    """Wall times (ms) of ``iters`` calls of ``fn(*args)``, each ending in a
    synchronize of ``device`` (``_sync``'s default: this process's card),
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def time_fn(
    fn: Callable[..., Any], *args: Any, iters: int = 10, warmup: int = 2, device: torch.device | None = None
) -> dict[str, float]:
    """Median and best wall time of a device function, synchronized."""
    times = wall_ms(fn, *args, iters=iters, warmup=warmup, device=device)
    return {"p50_ms": float(np.median(times)), "best_ms": float(np.min(times))}


def profile_engine_stages(cv_model: Any, batch_size: int = 32, iters: int = 5) -> dict[str, dict[str, float]]:
    """Per-stage timings of the pipeline on ``cv_model``'s device, each
    stage called on its own on seeded synthetic 512² frames: ``resize``,
    ``unet`` (the segmenter), ``quadrangle``, ``warp`` (homographies, gray,
    warp, flip) and ``classify`` (one classifier pass over the 64 crops of
    each board)."""
    dev = cv_model.device
    uniq = board_frames(0, min(batch_size, 4))[0]
    images = torch.from_numpy(np.concatenate([uniq] * -(-batch_size // len(uniq)))[:batch_size]).to(dev)
    ex_mod, _ = cv_model.board_extractor
    cl_mod, _ = cv_model.classifier
    input_hw = (constants.INPUT_SIZE[1], constants.INPUT_SIZE[0])
    dest = torch.tensor([[0.0, 0.0], [512.0, 0.0], [512.0, 512.0], [0.0, 512.0]], device=dev)

    def resize_fn(im: torch.Tensor) -> torch.Tensor:
        return resize(im, input_hw, round_uint8=True)

    def quad_fn(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return find_quadrangle_batch(p, 0.5)

    def warp_fn(im: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        ms = get_perspective_transform(q * 2.0, dest.expand(batch_size, 4, 2))
        return hflip(warp_perspective(bgr_to_gray(im.float()), ms, constants.BOARD_SIZE))

    def cls_fn(b: torch.Tensor) -> torch.Tensor:
        return cl_mod(extract_squares_batch(b).reshape(batch_size * 64, *constants.PIECE_SIZE, 1) / 255.0)

    with torch.inference_mode(), full_f32():
        x = resize_fn(images).float() / 255.0
        probs = torch.sigmoid(ex_mod(x)[..., 0].float())
        quads, _ = quad_fn(probs)
        boards = warp_fn(images, quads)
        return {
            "resize": time_fn(resize_fn, images, iters=iters, device=dev),
            "unet": time_fn(ex_mod, x, iters=iters, device=dev),
            "quadrangle": time_fn(quad_fn, probs, iters=iters, device=dev),
            "warp": time_fn(warp_fn, images, quads, iters=iters, device=dev),
            "classify": time_fn(cls_fn, boards, iters=iters, device=dev),
        }


def stage_breakdown(engine: Any, frames: np.ndarray) -> tuple[dict[str, float], float]:
    """Where the host's time goes in one profiled ``engine.process_batch(frames)``
    call: the host self time (ms) of each ``cv:`` span, keyed by the stage's
    name (``upload``, ``extractor``, ``copy_back``, ``device_wait``, ``mask``,
    ...; ``arbitrate`` summed over its chunks), and "other" the rest of the
    call's wall time.  A device stage's span holds only its launches: the
    host's wait for the device shows in ``device_wait``.  Returns (stages,
    the call's wall ms)."""
    _sync(engine.device)
    with _profiler() as prof:
        t0 = time.perf_counter()
        engine.process_batch(frames)
        _sync(engine.device)
        total = (time.perf_counter() - t0) * 1e3
    stages = span_self_ms(prof)
    stages["other"] = total - sum(stages.values())
    return stages, total


def span_self_ms(prof: Any) -> dict[str, float]:
    """Host self time (ms) of each name of a profiled region's ``cv:``
    spans, its prefix removed: each span's length less the parts that its
    child spans cover, summed over the spans of one name.  Spans nest (one
    thread opens and closes them in order)."""
    spans = sorted(
        ((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):]) for e in prof.events()
         if e.device_type != torch.autograd.DeviceType.CUDA and e.name.startswith(SPAN_PREFIX)),
        key=lambda s: (s[0], -s[1]),
    )
    out: dict[str, float] = {}
    open_: list[list[Any]] = []  # [start, end, name, time covered by children]

    def close() -> None:
        a, b, name, inner = open_.pop()
        out[name] = out.get(name, 0.0) + (b - a - inner) / 1e3

    for a, b, name in spans:
        while open_ and open_[-1][1] <= a:
            close()
        if open_:
            open_[-1][3] += b - a
        open_.append([a, b, name, 0.0])
    while open_:
        close()
    return out


def _device_events(prof: Any) -> list[Any]:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def device_busy(fn: Callable[[], Any]) -> tuple[float, float, str]:
    """(device busy ms, wall ms, table of the top ops by device time) of one
    synchronized call of ``fn`` under torch.profiler.  Busy is the length of
    the union of the device events' intervals (kernels, copies and fills on
    any stream), so two streams' overlap counts once."""
    _sync()
    with _profiler() as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(b - a for a, b in _union((e.time_range.start, e.time_range.end) for e in _device_events(prof)))
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15)
    return busy / 1e3, wall, table


def upload_overlap(prof: Any) -> dict[str, float]:
    """How much of a profiled region's host→device copy time ran while a
    kernel was running: ``h2d_ms`` is the summed duration of the copies,
    ``h2d_under_kernels_ms`` the part of it inside the union of the
    kernels' intervals, ``kernels_ms`` that union's length."""
    copies, kernels = [], []
    for e in _device_events(prof):
        interval = (e.time_range.start, e.time_range.end)
        if "memcpy" in e.name.lower():
            if "htod" in e.name.lower():
                copies.append(interval)
        elif "memset" not in e.name.lower():
            kernels.append(interval)
    merged = _union(kernels)
    under = 0.0
    for c0, c1 in copies:
        under += sum(max(0.0, min(c1, k1) - max(c0, k0)) for k0, k1 in merged)
    return {
        "h2d_copies": float(len(copies)),
        "h2d_ms": sum(c1 - c0 for c0, c1 in copies) / 1e3,
        "h2d_under_kernels_ms": under / 1e3,
        "kernels_ms": sum(k1 - k0 for k0, k1 in merged) / 1e3,
    }
