"""Microbenchmarks of the hot sub-stages on the card, the counterpart of
``scripts/microbench.py``.

``--which quad``: the quadrangle's sub-stages (``ops/quad.py``) on a
batch of 128 soft 256² board masks: a 9×9 box sum of the probabilities in
one 2-D pass and as two 1-D passes, the half-resolution flood fill from the
centre seed, and the hull support points with the 60-step decimation.

``--which warp``: K1 on the main path's shapes (128 gray 512² frames of
seeded synthetic boards, warped by their quads into the 576² canvas) in
the port's three formulations of the same function: ``warp_twopass`` (the
CUDA kernels), its plain version, and ``F.grid_sample`` once for each pass
with the positions given; the kernel's error against the plain version,
and the function's floor in bytes (``flops.tap_sector_bytes`` at the
card's memory rate).  K1 runs only on the card: ``--which warp``,
``route`` (and ``all``) raise with ``--device cpu`` rather than time the
plain version under K1's name.

``--which mask``: the threshold mask's kernel (``csrc/mask.cu``) at B=1
and B=128 of 256² logits beside its bytes floor and its plain version,
and on the host the formula it replaced against the host's part that is
left (card only).

``--which route``: the sweep that sets K1's route rule
(``hat_resample.warp_plan``): both routes of ``warp_twopass`` (the fused
kernel, and pass 1 + pass 2) timed on the same inputs, in turns (fused,
two-pass, two-pass, fused), warm (back to back) and cold (the L2 cache
flushed before each call), at B=1 frames of height 512, 1024, 2048, 3024,
4032 and 6048, each 4:3 and 3:4 (seeded gray frames made on the card, a
photo's board quad as the engine hands it to K1: x scaled by the height),
and at the main path's B=128 512²; each row with the route the rule
picks, the routes' largest difference (0: they give the same floats) and
the function's floor.

    python -m chessvision_tpu_torch.tools.microbench [--which warp|quad|mask|route|all] [--iters 5] [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.engine import _DEST
from chessvision_tpu_torch.ops import hat_resample as k1
from chessvision_tpu_torch.ops import mask as mask_ops
from chessvision_tpu_torch.ops.color import bgr_to_gray
from chessvision_tpu_torch.ops.quad import connected_component, decimate_to_quad, support_points
from chessvision_tpu_torch.ops.warp import get_perspective_transform, invert_homography
from chessvision_tpu_torch.profiling import wall_ms
from chessvision_tpu_torch.synthetic import board_frames
from chessvision_tpu_torch.tools import card, flops
from chessvision_tpu_torch.utils import full_f32, resolve_device

QUAD_BATCH, MASK_SIZE = 128, 256
WARP_BATCH, CANVAS, MARGIN = 128, 576, 32


# ---------------- quadrangle sub-stages ----------------
def quad_inputs(bsz: int, device: torch.device) -> dict[str, torch.Tensor]:
    """A soft board blob (B, 256, 256) and its mask at 0.5."""
    line = torch.linspace(-1.0, 1.0, MASK_SIZE, device=device)
    probs = torch.sigmoid(8.0 * (0.6 - torch.maximum(line.abs()[:, None], line.abs()[None, :])))
    probs = probs.expand(bsz, MASK_SIZE, MASK_SIZE)
    return {"probs": probs, "mask": probs > 0.5}


def _box_sum(p: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Sum over a kh×kw window centred on each pixel, zeros outside."""
    ones = torch.ones((1, 1, kh, kw), dtype=p.dtype, device=p.device)
    return F.conv2d(p[:, None], ones, padding=(kh // 2, kw // 2))[:, 0]


def quad_functions() -> dict[str, tuple[Callable[[torch.Tensor], Any], str]]:
    """Each sub-stage and the name of its ``quad_inputs``."""

    def smooth_9x9_2d(p: torch.Tensor) -> torch.Tensor:
        return _box_sum(p, 9, 9)

    def smooth_9x9_sep(p: torch.Tensor) -> torch.Tensor:
        return _box_sum(_box_sum(p, 9, 1), 1, 9)

    def flood_halfres(m: torch.Tensor) -> torch.Tensor:
        b, h, w = m.shape
        half = m.reshape(b, h // 2, 2, w // 2, 2).any(dim=4).any(dim=2)
        seeds = torch.full((b,), (h // 4) * (w // 2) + w // 4, dtype=torch.int64, device=m.device)
        return connected_component(half, seeds)

    def support_decimate(m: torch.Tensor) -> torch.Tensor:
        return decimate_to_quad(support_points(m))

    return {
        "smooth_9x9_2d": (smooth_9x9_2d, "probs"),
        "smooth_9x9_sep": (smooth_9x9_sep, "probs"),
        "flood_halfres": (flood_halfres, "mask"),
        "support_decimate": (support_decimate, "mask"),
    }


def bench_quad(iters: int, device: torch.device, bsz: int = QUAD_BATCH) -> dict[str, float]:
    """Median ms of each quadrangle sub-stage, each call synchronized."""
    inputs = quad_inputs(bsz, device)
    res = {}
    with torch.inference_mode(), full_f32():
        for name, (fn, key) in quad_functions().items():
            res[name] = round(float(np.median(wall_ms(fn, inputs[key], iters=iters, warmup=1, device=device))), 2)
            print(f"[bench] {name}: {res[name]} ms", file=sys.stderr, flush=True)
    return res


# ---------------- K1, the warp ----------------
def event_ms(fn: Callable[[], Any], iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def grid_sample_rows(src: torch.Tensor, pos: torch.Tensor) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing the hat resample of (..., J) rows at
    (..., U) positions: grid_sample over (N, 1, 1, J) rows with
    align_corners=True, zero padding, y = 0 (PyTorch's own CUDA sampler:
    cuDNN's refuses batches this large)."""
    j = src.shape[-1]
    inp = src.reshape(-1, 1, 1, j)
    x = pos.reshape(-1, 1, pos.shape[-1], 1) * (2.0 / (j - 1)) - 1.0
    grid = torch.cat([x, torch.zeros_like(x)], dim=-1)

    def call() -> torch.Tensor:
        with torch.backends.cudnn.flags(enabled=False):
            return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    return call


def warp_inputs(bsz: int, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's main-path inputs: gray float32 frames (B, 512, 512) of seeded
    synthetic boards (32 distinct, tiled) and the inverse homographies
    (B, 3, 3) that take each board's quad into the 576² canvas."""
    frames, quads = board_frames(seed, min(bsz, 32))
    reps = -(-bsz // len(frames))
    frames = torch.from_numpy(np.concatenate([frames] * reps)[:bsz]).to(device)
    quads = torch.from_numpy(np.concatenate([quads] * reps)[:bsz]).float().to(device)
    dest = torch.from_numpy(_DEST).to(device) + float(MARGIN)
    with full_f32():
        minv = invert_homography(get_perspective_transform(quads, dest.expand(bsz, 4, 2))).contiguous()
    return bgr_to_gray(frames, exact_u8=True).float(), minv


def warp_floor(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int,
               bytes_per_s: float) -> tuple[int, float]:
    """The warp's floor: the 32-byte source sectors its taps touch
    (``flops.tap_sector_bytes``), the matrices read and the boards written,
    in bytes of taps and in ms at ``bytes_per_s``."""
    hx, vy = k1.twopass_positions(minv, imgs.shape[1], out_h, out_w)
    tap_bytes = flops.tap_sector_bytes(imgs, hx, vy)
    io_bytes = 4 * (minv.numel() + imgs.shape[0] * out_h * out_w)
    return tap_bytes, (tap_bytes + io_bytes) / bytes_per_s * 1e3


def warp_times(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int, plain_iters: int,
               bytes_per_s: float) -> dict[str, Any]:
    """K1 (``warp_twopass``), its plain version and ``grid_sample`` once for
    each pass with the positions given, timed (ms) on one warp's inputs;
    grid_sample's largest difference from the plain version; the floor
    (``warp_floor``)."""
    b, src_h = imgs.shape[:2]
    hx, vy = k1.twopass_positions(minv, src_h, out_h, out_w)
    lib1 = grid_sample_rows(imgs, hx)
    lib2 = grid_sample_rows(k1.warp_pass1(imgs, minv, out_w).transpose(1, 2), vy)
    want = k1.warp_twopass_plain(imgs, minv, out_h, out_w)
    tap_bytes, bound_ms = warp_floor(imgs, minv, out_h, out_w, bytes_per_s)
    return {
        "ms": event_ms(lambda: k1.warp_twopass(imgs, minv, out_h, out_w), iters=20),
        "plain_ms": event_ms(lambda: k1.warp_twopass_plain(imgs, minv, out_h, out_w), plain_iters, 1),
        "library_ms": event_ms(lib1, iters=20) + event_ms(lib2, iters=20),
        "library_max_abs_diff": float((lib2().reshape(b, out_w, out_h).transpose(1, 2) - want).abs().max()),
        "tap_bytes": tap_bytes,
        "bound_ms": bound_ms,
    }


def cold_ms(fn: Callable[[], Any], iters: int, flush_bytes: int = 256 << 20) -> float:
    """Mean device time of ``fn`` with the card's L2 cache flushed before
    each call (a buffer five times the H100's 50 MB L2 written in between),
    by CUDA events around each call alone."""
    scratch = torch.empty(flush_bytes // 4, device=torch.cuda.current_device())
    fn()
    events = []
    for _ in range(iters):
        scratch.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------- the threshold mask ----------------
MASK_BATCHES = (1, 128)


# about 50 ms of the card's clock: the spin that holds the stream while the host queues the timed calls
_HOLD_CYCLES = 100_000_000


def kernel_ms(fn: Callable[[], Any], iters: int, flush_bytes: int = 0) -> float:
    """Mean device time (ms) of a call of ``fn``, by CUDA events around each
    call.  The calls are queued behind a spin kernel, so each pair of
    events brackets the device's work of one call and not the host's
    launch of it, which takes longer than a short kernel runs.  With
    ``flush_bytes`` a buffer of that size is written before each call,
    outside its events, so the call finds its inputs outside the L2 cache.
    Raises where the device reached the first call before the host had
    queued the last."""
    scratch = torch.empty(flush_bytes // 4, device=torch.cuda.current_device()) if flush_bytes else None
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(_HOLD_CYCLES)
    for start, end in events:
        if scratch is not None:
            scratch.zero_()
        start.record()
        fn()
        end.record()
    held = not events[0][0].query()
    torch.cuda.synchronize()
    if not held:
        raise RuntimeError("kernel_ms: the device reached the timed calls before the host had queued them all")
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bench_mask(iters: int, device: torch.device, seed: int = 0) -> dict[str, Any]:
    """For B=1 and B=128 seeded N(0, 8²) logits of 256² at t=0.5: the mask
    kernel's device ms a call (``kernel_ms``: the count's zeroing and the
    kernel), warm (back to back: the 33.5 MB of logits at B=128 fit the
    50 MB L2) and cold (the L2 flushed before each call), its bytes floor (4 B read and 1 written a pixel at the card's
    memory rate), its plain version's ms, whether the two agree, the band
    pixels; and on the host the median ms of the formula the kernel
    replaced and of ``engine._binary_mask`` given the kernel's outputs
    (which settles the listed band pixels)."""
    if device.type != "cuda":
        raise ValueError("microbench --which mask times the mask kernel, which runs only on the card")
    lo, hi = mask_ops.band(0.5)
    bytes_per_s = card.peaks(card.card_fields(device)["device"])["bytes_per_s"]
    gen = torch.Generator(device=device).manual_seed(seed)
    res: dict[str, Any] = {}
    for b in MASK_BATCHES:
        x = torch.randn((b, MASK_SIZE, MASK_SIZE), generator=gen, device=device) * 8
        mask, band = mask_ops.binary_mask(x, lo, hi)
        want_mask, want_band = mask_ops.binary_mask_plain(x, lo, hi)
        host_x, host_mask, host_band = x.cpu().numpy(), mask.cpu().numpy(), band.cpu().numpy()
        n = int(host_band[0])
        res[f"mask_b{b}"] = rec = {
            "kernel_ms": kernel_ms(lambda: mask_ops.binary_mask(x, lo, hi), iters),
            "kernel_cold_ms": kernel_ms(lambda: mask_ops.binary_mask(x, lo, hi), iters, flush_bytes=256 << 20),
            "bound_ms": 1e3 * x.numel() * 5 / bytes_per_s,
            "plain_ms": event_ms(lambda: mask_ops.binary_mask_plain(x, lo, hi), iters),
            "equal": bool(torch.equal(mask, want_mask) and n == int(want_band[0]) and n <= mask_ops.BAND_LIST
                          and sorted(host_band[1 : 1 + n]) == want_band[1 : 1 + n].tolist()),
            "band_pixels": n,
            "host_formula_ms": float(np.median(wall_ms(mask_ops.formula, host_x, 0.5, iters=iters, warmup=1))),
            "host_settle_ms": float(np.median(wall_ms(
                lambda: engine_mod._binary_mask(host_x, 0.5, host_mask.copy(), host_band), iters=iters, warmup=1))),
        }
        print(f"[bench] mask B={b}: {rec}", file=sys.stderr, flush=True)
    return res


ROUTE_HEIGHTS = (512, 1024, 2048, 3024, 4032, 6048)


def route_shapes() -> list[tuple[int, int, int]]:
    """The route sweep's (b, h, w): B=1 frames of each height at a 4:3
    and a 3:4 width, then the main path's B=128 512²."""
    return [(1, h, w) for h in ROUTE_HEIGHTS for w in (h * 4 // 3, h * 3 // 4)] + [(WARP_BATCH, 512, 512)]


def photo_inputs(b: int, h: int, w: int, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded gray frames (b, h, w) made on the card, and the inverse
    homographies (b, 3, 3) that take a photo's board quad into the 576²
    canvas as the engine hands it to K1: the board 55–85% of the short
    side, turned up to 7°, x scaled by the height (the reference quirk of
    ``scale_quadrangle``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randint(0, 256, (b, h, w), generator=g, device=device).float()
    rng = np.random.default_rng(seed)
    quads = []
    for _ in range(b):
        side = rng.uniform(0.55, 0.85) * min(h, w)
        center = [rng.uniform(side / 2, w - side / 2), rng.uniform(side / 2, h - side / 2)]
        a = rng.uniform(-0.12, 0.12)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        q = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * side / 2 @ rot.T + center
        quads.append(q * [h / w, 1.0])
    dest = torch.from_numpy(_DEST).to(device) + float(MARGIN)
    q = torch.from_numpy(np.stack(quads)).float().to(device)
    with full_f32():
        minv = invert_homography(get_perspective_transform(q, dest.expand(b, 4, 2))).contiguous()
    return imgs, minv


def route_times(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int, iters: int) -> dict[str, Any]:
    """Both routes of ``warp_twopass`` on one warp's inputs, ms by CUDA
    events: warm (mean of two runs of ``iters`` back-to-back calls, in the
    turns fused, two-pass, two-pass, fused) and cold (``cold_ms``); the
    route ``warp_plan`` picks and the routes' largest difference."""
    def fused():
        return k1.warp_fused(imgs, minv, out_h, out_w)

    def twopass():
        return k1.warp_pass2(k1.warp_pass1(imgs, minv, out_w), minv, out_h)

    fused_a, twopass_a, twopass_b, fused_b = (event_ms(fn, iters) for fn in (fused, twopass, twopass, fused))
    return {
        "route": k1.warp_plan(*imgs.shape, out_h, out_w),
        "fused_ms": (fused_a + fused_b) / 2,
        "twopass_ms": (twopass_a + twopass_b) / 2,
        "fused_cold_ms": cold_ms(fused, iters),
        "twopass_cold_ms": cold_ms(twopass, iters),
        "routes_max_abs_diff": float((fused() - twopass()).abs().max()),
    }


def bench_route(device: torch.device, seed: int = 0, iters: int = 20) -> dict[str, Any]:
    """The route sweep (module docstring): one row a shape of
    ``route_shapes``, and the rule it was read against."""
    if device.type != "cuda":
        raise ValueError("microbench --which route times K1's kernels, which run only on the card")
    bytes_per_s = card.peaks(card.card_fields(device)["device"])["bytes_per_s"]
    rows = []
    for b, h, w in route_shapes():
        imgs, minv = warp_inputs(b, seed, device) if b == WARP_BATCH else photo_inputs(b, h, w, seed, device)
        row = {"shape": [b, h, w, CANVAS, CANVAS], **route_times(imgs, minv, CANVAS, CANVAS, iters),
               "bound_ms": warp_floor(imgs, minv, CANVAS, CANVAS, bytes_per_s)[1]}
        rows.append(row)
        print(f"[bench] route {row['shape']}: fused {row['fused_ms']:.4f} / cold {row['fused_cold_ms']:.4f} ms, "
              f"two-pass {row['twopass_ms']:.4f} / cold {row['twopass_cold_ms']:.4f} ms, plan {row['route']}",
              file=sys.stderr, flush=True)
        del imgs, minv
    return {"route_sweep": rows, "route_rule": f"fused if h >= {k1.FUSED_MIN_RATIO} * out_h"}


def bench_warp(iters: int, device: torch.device, seed: int = 0, bsz: int = WARP_BATCH) -> dict[str, Any]:
    """K1's time, its plain version's and grid_sample's at the main path's
    shapes (``warp_times``), its error against the plain version, and its
    floor."""
    if device.type != "cuda":
        raise ValueError("microbench --which warp times K1, whose kernels run only on the card; "
                         "the CPU would time the plain version under K1's name")
    imgs, minv = warp_inputs(bsz, seed, device)
    err = (k1.warp_twopass(imgs, minv, CANVAS, CANVAS) - k1.warp_twopass_plain(imgs, minv, CANVAS, CANVAS)).abs().max()
    t = warp_times(imgs, minv, CANVAS, CANVAS, iters, card.peaks(card.card_fields(device)["device"])["bytes_per_s"])
    return {
        "warp_shape": [list(imgs.shape), CANVAS, CANVAS],
        "warp_twopass_ms": t["ms"],
        "warp_twopass_plain_ms": t["plain_ms"],
        "grid_sample_twice_ms": t["library_ms"],
        "warp_max_abs_err": float(err),
        "grid_sample_max_abs_diff": t["library_max_abs_diff"],
        "warp_tap_bytes": t["tap_bytes"],
        "warp_bound_ms": t["bound_ms"],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Microbenchmarks of the PyTorch port's quad sub-stages and K1")
    ap.add_argument("--which", choices=["warp", "quad", "mask", "route", "all"], default="all")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (quad only)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    out: dict[str, Any] = {"backend": dev.type, **card.card_fields(dev)}
    if a.which in ("warp", "all"):
        out.update(bench_warp(a.iters, dev))
    if a.which in ("quad", "all"):
        out.update(bench_quad(a.iters, dev))
    if a.which in ("mask", "all"):
        out.update(bench_mask(a.iters, dev))
    if a.which in ("route", "all"):
        out.update(bench_route(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
