"""Drive the PyTorch port of chessvision on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failure exits non-zero without the final result line):

1. build: compile every CUDA kernel of the port from ``chessvision_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. main path: ``ChessVision.process_image`` and ``Engine.process_batch``
   (refine="arbitrate", margin 32) with the committed UNet(base=32) and
   ResNet18 weights in bfloat16 on synthetic 512² frames made from
   ``--seed``; each kernel's launch count is zeroed just before and read
   just after, and must have risen;
3. plain path: the same batch with each kernel swapped for its plain
   PyTorch version must give the same ``found`` flags, FENs and boards;
4. kernels vs plain: each kernel's wrapper on the inputs the main path
   gave it, at batch 8 and 128, and on border and upscale cases, against
   its plain version (stated tolerance), with its time, the plain
   version's, a one-call PyTorch yardstick's and the least time the card
   could take (bound);
5. numbers: boards/s at batch 128 and p50 latency at batch 1 (full and
   lite), with the card's name and power limit.

Output: a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Needs no network.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
K1_TOL = 1e-5  # kernel vs plain: same weights, products and one rounded sum
BATCH = 128  # the throughput cell, and the kernels' timing shapes


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> list[float]:
    """Host wall times (ms) of ``fn``, each ending in a synchronize."""
    import torch

    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def percentile(xs: list[float], q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def capture_k1(k1, fn):
    """Run ``fn`` with the K1 wrapper recording each (src, pos) it is given."""
    calls = []
    orig = k1.hat_resample

    def recording(src, pos):
        calls.append((src, pos))
        return orig(src, pos)

    k1.hat_resample = recording
    try:
        result = fn()
    finally:
        k1.hat_resample = orig
    return result, calls


def with_plain_k1(k1, fn):
    """Run ``fn`` with K1 swapped for its plain PyTorch version."""
    orig = k1.hat_resample
    k1.hat_resample = k1.hat_resample_plain
    try:
        return fn()
    finally:
        k1.hat_resample = orig


def k1_library(src, pos):
    """One PyTorch call computing the hat resample: grid_sample over
    (N, 1, 1, J) rows with align_corners=True, zero padding, y = 0."""
    import torch
    import torch.nn.functional as F

    j = src.shape[-1]
    inp = src.reshape(-1, 1, 1, j)
    x = pos.reshape(-1, 1, pos.shape[-1], 1) * (2.0 / (j - 1)) - 1.0
    grid = torch.cat([x, torch.zeros_like(x)], dim=-1)

    def call():
        # PyTorch's own CUDA sampler: cuDNN's refuses batches this large
        with torch.backends.cudnn.flags(enabled=False):
            return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    return call


def k1_bytes(src, pos) -> int:
    """Bytes the function must move: src and pos read once, out written once."""
    return 4 * (src.numel() + 2 * pos.numel())


def measure_k1(k1, calls, plain_iters: int) -> dict:
    """Kernel, plain and library times (ms, summed over the calls), bound
    and max |kernel − plain| on the main path's own K1 inputs."""
    import torch

    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "library_max_abs_diff": 0.0, "shapes": []}
    for src, pos in calls:
        got = k1.hat_resample(src, pos)
        torch.cuda.synchronize()
        want = k1.hat_resample_plain(src, pos)
        res["max_abs_err"] = max(res["max_abs_err"], float((got - want).abs().max()))
        lib = k1_library(src, pos)
        lib_out = lib().reshape(got.shape)
        res["library_max_abs_diff"] = max(res["library_max_abs_diff"], float((lib_out - want).abs().max()))
        ms = cuda_ms(lambda: k1.hat_resample(src, pos), iters=20)
        plain = cuda_ms(lambda: k1.hat_resample_plain(src, pos), iters=plain_iters, warmup=1)
        library = cuda_ms(lib, iters=20)
        bound = k1_bytes(src, pos) / HBM_BYTES_PER_S * 1e3
        res["ms"] += ms
        res["plain_ms"] += plain
        res["library_ms"] += library
        res["bound_ms"] += bound
        detail = {"src": list(src.shape), "pos": list(pos.shape), "src_contiguous": src.is_contiguous(),
                  "ms": ms, "plain_ms": plain, "library_ms": library, "bound_ms": bound}
        if not src.is_contiguous():  # the wrapper's copy of a transposed source, apart
            src_c = src.contiguous()
            detail["ms_on_contiguous_src"] = cuda_ms(lambda: k1.hat_resample(src_c, pos), iters=20)
        res["shapes"].append(detail)
    return res


def stage_breakdown(engine, frames, iters: int) -> tuple[dict, float]:
    """Mean synchronized wall time (ms) of each pipeline stage inside
    ``engine.process_batch(frames)``; "other" is the rest (copies to and
    from the card, homographies, rounding, FEN strings)."""
    import torch

    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.ops import gridfix

    acc: dict[str, float] = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return run

    targets = [
        (engine_mod, "preprocess_images"),
        (engine_mod, "find_quadrangle_batch"),
        (engine_mod, "warp_perspective"),
        (gridfix, "detect_grid"),
        (engine_mod, "_arbitrate_chunk"),
        (engine_mod, "validate_labels_batch"),
    ]
    saved = [(m, n, getattr(m, n)) for m, n in targets]
    extractor = engine._extractor
    for m, n, f in saved:
        setattr(m, n, timed(n, f))
    engine._extractor = timed("unet", extractor)
    try:
        totals = host_ms(lambda: engine.process_batch(frames), iters)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
        engine._extractor = extractor
    stages = {k: v / iters for k, v in acc.items()}
    total = sum(totals) / iters
    stages["other"] = total - sum(stages.values())
    return stages, total


def device_busy(engine, frames) -> tuple[float, float, str]:
    """(device busy ms, wall ms, top-op table) of one process_batch under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.process_batch(frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15)
    return busy, wall, table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="also print stage times, device busy share and peak memory")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from chessvision_tpu_torch import cuda_build
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.synthetic import board_frames

    t_start = time.perf_counter()
    dev_name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    card = smi[0] if smi else f"{dev_name}, power limit not read"
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    # -- 1. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    names = cuda_build.build_all(verbose=True)
    log(f"[build] {names} in {time.perf_counter() - t0:.1f} s")

    # -- 2. main path ----------------------------------------------------------------
    frames8, _ = board_frames(args.seed, 8)
    cv = ChessVision(device="cuda")  # bfloat16 models, refine="arbitrate", margin 32
    engine = cv.engine
    engine.process_batch(frames8)  # warm-up: cuDNN algorithm choice, lazy inits
    torch.cuda.synchronize()

    k1.launches = 0
    single = cv.process_image(frames8[0])
    (res8, calls8) = capture_k1(k1, lambda: engine.process_batch(frames8))
    torch.cuda.synchronize()
    launches = k1.launches
    log(f"[main] process_image found={single.board_extraction.quadrangle is not None} "
        f"fen={single.position.fen if single.position else ''!r}")
    log(f"[main] process_batch B=8 found={res8.board_found.tolist()} fens={res8.fens}")
    log(f"[main] hat_resample launches over process_image + process_batch: {launches}")
    if launches != 4:
        raise SystemExit(f"FAIL: expected 4 K1 launches (2 per pipeline call), got {launches}")
    if not (res8.probabilities.shape == (8, 64, 13) and np.isfinite(res8.probabilities).all()):
        raise SystemExit("FAIL: probabilities not finite (8, 64, 13)")
    if res8.board_image.shape != (8, 512, 512) or res8.logits.shape != (8, 256, 256):
        raise SystemExit("FAIL: unexpected output shapes")
    if not np.allclose(res8.probabilities.sum(-1), 1.0, atol=1e-3):
        raise SystemExit("FAIL: probabilities do not sum to 1")
    if not res8.board_found.any():
        raise SystemExit("FAIL: no board found on any synthetic frame")
    single_fen = single.position.fen if single.position is not None else ""
    if (single.position is not None) != bool(res8.board_found[0]) or single_fen != res8.fens[0]:
        raise SystemExit("FAIL: process_image disagrees with process_batch on frame 0")
    lite = engine.process_batch(frames8, lite=True)
    if lite.fens != res8.fens:
        raise SystemExit("FAIL: lite FENs differ from full FENs")

    # -- 3. the same batch through the plain resample ----------------------------------------
    res_plain = with_plain_k1(k1, lambda: engine.process_batch(frames8))
    board_diff = np.abs(res_plain.board_image.astype(int) - res8.board_image.astype(int))
    prob_diff = float(np.abs(res_plain.probabilities - res8.probabilities).max())
    log(f"[plain] found equal={bool((res_plain.board_found == res8.board_found).all())} "
        f"fens equal={res_plain.fens == res8.fens} board max diff={int(board_diff.max())} "
        f"prob max diff={prob_diff}")
    if not ((res_plain.board_found == res8.board_found).all() and res_plain.fens == res8.fens):
        raise SystemExit("FAIL: plain-resample path gives other found flags or FENs")
    # tolerance: boards within 1 gray level on ≤ 0.1% of pixels (the kernel
    # is expected bit-exact, which gives 0)
    if board_diff.max() > 1 or np.mean(board_diff > 0) > 1e-3:
        raise SystemExit("FAIL: plain-resample boards differ")

    # -- 4. kernel vs plain ---------------------------------------------------------------
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    edge = []
    for lo, hi in ((-3.0, 514.0), (200.0, 300.0)):  # border and upscale cases
        src = torch.rand((32, 512), generator=g).cuda()
        pos = (torch.linspace(lo, hi, 576)[None] + 0.3 * torch.arange(32)[:, None]).cuda()
        got = k1.hat_resample(src, pos)
        torch.cuda.synchronize()
        edge.append(float((got - k1.hat_resample_plain(src, pos)).abs().max()))
    log(f"[k1] border/upscale max |kernel - plain| = {edge}")
    k1_8 = measure_k1(k1, calls8, plain_iters=5)
    log(f"[k1] B=8 {json.dumps(k1_8)}")

    bsz = BATCH
    uniq = board_frames(args.seed + 1, min(bsz, 32))[0]
    frames128 = np.concatenate([uniq] * (-(-bsz // len(uniq))))[:bsz]
    engine.process_batch(frames128)  # warm-up at this batch
    k1.launches = 0
    res128, calls128 = capture_k1(k1, lambda: engine.process_batch(frames128))
    torch.cuda.synchronize()
    launches128 = k1.launches
    log(f"[main] hat_resample launches over process_batch B={bsz}: {launches128}")
    if launches128 != 2:
        raise SystemExit(f"FAIL: expected 2 K1 launches at B={bsz}, got {launches128}")
    k1_128 = measure_k1(k1, calls128, plain_iters=2)
    log(f"[k1] B={bsz} {json.dumps(k1_128)}")
    worst = max([k1_8["max_abs_err"], k1_128["max_abs_err"], *edge])
    if worst > K1_TOL:
        raise SystemExit(f"FAIL: K1 kernel differs from plain by {worst} > {K1_TOL}")
    del calls8, calls128

    # -- 5. numbers ---------------------------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t128 = host_ms(lambda: engine.process_batch(frames128), iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x128 = torch.from_numpy(frames128).cuda()
    dev128 = host_ms(lambda: engine.run_device(x128), iters=5)
    one = frames8[:1]
    lat_full, lat_lite = [], []
    for _ in range(40):  # interleaved, so drift hits both alike
        lat_full += host_ms(lambda: engine.process_batch(one), iters=1)
        lat_lite += host_ms(lambda: engine.process_batch(one, lite=True), iters=1)
    log(f"[numbers] {card}")
    log(f"[numbers] B={bsz} bf16 process_batch: median {percentile(t128, 0.5):.2f} ms -> "
        f"{bsz * 1e3 / percentile(t128, 0.5):.1f} boards/s (frames from host memory to FENs); "
        f"run_device on frames already on the card: median {percentile(dev128, 0.5):.2f} ms -> "
        f"{bsz * 1e3 / percentile(dev128, 0.5):.1f} boards/s; peak memory {peak_gb:.2f} GB; "
        f"found {int(res128.board_found.sum())}/{bsz}")
    log(f"[numbers] B=1 latency p50 full {percentile(lat_full, 0.5):.2f} ms, "
        f"p50 lite {percentile(lat_lite, 0.5):.2f} ms (p90 {percentile(lat_full, 0.9):.2f} / "
        f"{percentile(lat_lite, 0.9):.2f} ms)")

    if args.profile:
        # one whole arbitrate chunk (512 boards) must fit the card
        chunk = engine_mod._ARBITRATE_CHUNK
        x_chunk = x128.repeat(-(-chunk // bsz), 1, 1, 1)[:chunk]
        torch.cuda.reset_peak_memory_stats()
        engine.run_device(x_chunk)
        torch.cuda.synchronize()
        log(f"[memory] run_device B={chunk} (one arbitrate chunk): peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del x_chunk
        for name, frames in ((f"B={bsz}", frames128), ("B=1", one)):
            stages, total = stage_breakdown(engine, frames, iters=3)
            log(f"[stages] {name} process_batch {total:.2f} ms (stages synchronized): "
                + json.dumps({k: round(v, 3) for k, v in stages.items()}))
            busy, wall, table = device_busy(engine, frames)
            log(f"[profile] {name} process_batch: device busy {busy:.2f} ms of {wall:.2f} ms wall "
                f"({100 * busy / wall:.1f}%), top ops by device time\n{table}")

    # f32 parity mode on the card (TF32 off): informational agreement with bf16
    cv32 = ChessVision(device="cuda", dtype=torch.float32)
    res32 = cv32.engine.process_batch(frames8)
    agree = sum(a == b for a, b in zip(res32.fens, res8.fens))
    log(f"[f32] found equal={bool((res32.board_found == res8.board_found).all())}, "
        f"FENs equal bf16 vs f32: {agree}/8")

    kernels = [{
        "name": "hat_resample",
        "route": "cuda",
        "source": "chessvision_tpu_torch/csrc/hat_resample.cu",
        "replaces": "chessvision_tpu/ops/pallas_kernels.py:123",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k1_128["ms"],
        "plain_ms": k1_128["plain_ms"],
        "bound_ms": k1_128["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1_128["library_ms"],
    }]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
