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
4. kernels vs plain: both entries of K1 against their plain versions
   (stated tolerance): ``warp_twopass`` on the inputs the main path gave
   it at batch 8 and 128 and on seeded rotated, out-of-frame and identity
   quads, ``hat_resample`` on the positions of the same inputs and on
   border and upscale cases; then the times at batch 128 of the warp, of
   each pass, of the route with the positions in memory, of the plain
   version and of a PyTorch yardstick, beside the least time the card
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
# kernel vs plain: the same positions (every operation rounded to nearest, as
# the plain version's eager ops round), weights, products and one rounded sum
K1_TOL = 1e-5
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
    """Run ``fn`` with both K1 entries recording the arguments they are given."""
    calls = {"warp_twopass": [], "hat_resample": []}
    saved = {name: getattr(k1, name) for name in calls}

    def recording(name):
        def run(*args):
            calls[name].append(args)
            return saved[name](*args)

        return run

    for name in calls:
        setattr(k1, name, recording(name))
    try:
        result = fn()
    finally:
        for name, orig in saved.items():
            setattr(k1, name, orig)
    return result, calls


def with_plain_k1(k1, fn):
    """Run ``fn`` with both K1 entries swapped for their plain PyTorch versions."""
    saved = (k1.warp_twopass, k1.hat_resample)
    k1.warp_twopass, k1.hat_resample = k1.warp_twopass_plain, k1.hat_resample_plain
    try:
        return fn()
    finally:
        k1.warp_twopass, k1.hat_resample = saved


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


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def check_k1(k1, imgs, minv, out_h: int, out_w: int) -> dict:
    """max |kernel − plain| of both entries on one warp's inputs:
    ``warp_twopass`` whole, and ``hat_resample`` on each pass's source and
    positions (pass 2's source is the transposed view, read in place)."""
    import torch

    hx, vy = k1.twopass_positions(minv, imgs.shape[1], out_h, out_w)
    tmp = k1.hat_resample_plain(imgs, hx)
    want = k1.hat_resample_plain(tmp.transpose(1, 2), vy).transpose(1, 2)
    got = k1.warp_twopass(imgs, minv, out_h, out_w)
    torch.cuda.synchronize()
    if not (got.is_contiguous() and got.shape == (imgs.shape[0], out_h, out_w)):
        raise SystemExit("FAIL: warp_twopass result is not a contiguous (B, out_h, out_w)")
    errs = {
        "warp_twopass": max_err(got, want),
        "hat_resample_pass1": max_err(k1.hat_resample(imgs, hx), tmp),
        "hat_resample_pass2": max_err(k1.hat_resample(tmp.transpose(1, 2), vy).transpose(1, 2), want),
    }
    torch.cuda.synchronize()
    return errs


def seeded_quads(seed: int):
    """Three (4, 2) quads in a 512² frame that the synthetic frames may not
    give: rotated ~30°, partly outside the frame, and the identity quad of
    a board that was not found."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rotated(deg, side, center):
        a = np.deg2rad(deg)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * side / 2 @ rot.T + center

    return np.stack([
        rotated(30.0 + rng.uniform(-2, 2), rng.uniform(280, 320), rng.uniform(246, 266, 2)),
        rotated(rng.uniform(5, 10), rng.uniform(400, 440), rng.uniform(380, 410, 2)),
        np.array([[0, 0], [512, 0], [512, 512], [0, 512]], np.float64),
    ]).astype(np.float32)


def time_k1(k1, imgs, minv, out_h: int, out_w: int, plain_iters: int) -> dict:
    """Times (ms) on one warp's inputs: the two kernels together and each
    alone; the route with the positions in memory (positions built by torch
    ops, then ``hat_resample`` for each pass); the plain version; and the
    grid_sample yardstick given the positions, and with building them.
    Bounds: the function's own bytes (images read, boards written) and the
    two-kernel design's (the intermediate written and read as well), at the
    data sheet's memory rate; ``copy_tb_per_s`` is what a device-to-device
    copy of the images reaches (bytes read + written over its time)."""
    import torch

    src_h = imgs.shape[1]
    res = {"shape": [list(imgs.shape), out_h, out_w]}
    res["ms"] = cuda_ms(lambda: k1.warp_twopass(imgs, minv, out_h, out_w), iters=20)
    tmp = k1.warp_pass1(imgs, minv, out_w)
    res["pass1_ms"] = cuda_ms(lambda: k1.warp_pass1(imgs, minv, out_w), iters=20)
    res["pass2_ms"] = cuda_ms(lambda: k1.warp_pass2(tmp, minv, out_h), iters=20)

    def positions_route():
        hx, vy = k1.twopass_positions(minv, src_h, out_h, out_w)
        mid = k1.hat_resample(imgs, hx)
        return k1.hat_resample(mid.transpose(1, 2), vy).transpose(1, 2)

    hx, vy = k1.twopass_positions(minv, src_h, out_h, out_w)
    tmp_t = tmp.transpose(1, 2)
    res["positions_route_ms"] = cuda_ms(positions_route, iters=10)
    res["positions_ms"] = cuda_ms(lambda: k1.twopass_positions(minv, src_h, out_h, out_w), iters=10)
    res["hat_resample_pass1_ms"] = cuda_ms(lambda: k1.hat_resample(imgs, hx), iters=20)
    res["hat_resample_pass2_ms"] = cuda_ms(lambda: k1.hat_resample(tmp_t, vy), iters=20)
    res["plain_ms"] = cuda_ms(lambda: k1.warp_twopass_plain(imgs, minv, out_h, out_w), iters=plain_iters, warmup=1)

    lib1, lib2 = k1_library(imgs, hx), k1_library(tmp_t, vy)
    res["library_ms"] = cuda_ms(lib1, iters=20) + cuda_ms(lib2, iters=20)

    def library_with_positions():
        hx_, vy_ = k1.twopass_positions(minv, src_h, out_h, out_w)
        mid = k1_library(imgs, hx_)().reshape(imgs.shape[0], src_h, out_w)
        return k1_library(mid.transpose(1, 2), vy_)()

    res["library_with_positions_ms"] = cuda_ms(library_with_positions, iters=5)
    want = k1.hat_resample_plain(tmp_t, vy)
    res["library_max_abs_diff"] = max_err(lib2().reshape(want.shape), want)
    scratch = torch.empty_like(imgs)
    res["copy_tb_per_s"] = 8 * imgs.numel() / cuda_ms(lambda: scratch.copy_(imgs), iters=20) / 1e9
    function_bytes = 4 * (imgs.numel() + minv.numel() + imgs.shape[0] * out_h * out_w)
    res["bound_ms"] = function_bytes / HBM_BYTES_PER_S * 1e3
    res["two_kernel_floor_ms"] = (function_bytes + 8 * tmp.numel()) / HBM_BYTES_PER_S * 1e3
    res["positions_route_floor_ms"] = (
        function_bytes + 4 * (2 * tmp.numel() + hx.numel() + vy.numel())
    ) / HBM_BYTES_PER_S * 1e3
    torch.cuda.synchronize()
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
    from chessvision_tpu_torch.ops.warp import get_perspective_transform, invert_homography
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
    res8, calls8 = capture_k1(k1, lambda: engine.process_batch(frames8))
    torch.cuda.synchronize()
    launches = k1.launches
    log(f"[main] process_image found={single.board_extraction.quadrangle is not None} "
        f"fen={single.position.fen if single.position else ''!r}")
    log(f"[main] process_batch B=8 found={res8.board_found.tolist()} fens={res8.fens}")
    log(f"[main] K1 launches over process_image + process_batch: {launches}; entries called in "
        f"process_batch: {({k: len(v) for k, v in calls8.items()})}")
    if launches != 4:
        raise SystemExit(f"FAIL: expected 4 K1 launches (2 per pipeline call), got {launches}")
    if len(calls8["warp_twopass"]) != 1 or calls8["hat_resample"]:
        raise SystemExit("FAIL: the main path should call warp_twopass once and hat_resample never")
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

    # -- 3. the same batch through the plain warp --------------------------------------------
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
    errs = {}
    for name, (lo, hi) in (("border", (-3.0, 514.0)), ("upscale", (200.0, 300.0))):
        src = torch.rand((32, 512), generator=g).cuda()
        pos = (torch.linspace(lo, hi, 576)[None] + 0.3 * torch.arange(32)[:, None]).cuda()
        got = k1.hat_resample(src, pos)
        torch.cuda.synchronize()
        errs[name] = {"hat_resample": max_err(got, k1.hat_resample_plain(src, pos))}
    dest = torch.from_numpy(engine_mod._DEST).cuda()
    quads = torch.from_numpy(seeded_quads(args.seed)).cuda()
    minv_q = invert_homography(get_perspective_transform(quads, (dest + 32.0).expand(3, 4, 2))).contiguous()
    imgs_q = torch.randint(0, 256, (3, 512, 512), generator=g).float().cuda()
    errs["rotated/out-of-frame/identity"] = check_k1(k1, imgs_q, minv_q, 576, 576)
    errs["B=8"] = check_k1(k1, *calls8["warp_twopass"][0])

    bsz = BATCH
    uniq = board_frames(args.seed + 1, min(bsz, 32))[0]
    frames128 = np.concatenate([uniq] * (-(-bsz // len(uniq))))[:bsz]
    engine.process_batch(frames128)  # warm-up at this batch
    k1.launches = 0
    res128, calls128 = capture_k1(k1, lambda: engine.process_batch(frames128))
    torch.cuda.synchronize()
    launches128 = k1.launches
    log(f"[main] K1 launches over process_batch B={bsz}: {launches128}")
    if launches128 != 2:
        raise SystemExit(f"FAIL: expected 2 K1 launches at B={bsz}, got {launches128}")
    warp128 = calls128["warp_twopass"][0]
    errs[f"B={bsz}"] = check_k1(k1, *warp128)
    log(f"[k1] max |kernel - plain| by case and entry: {json.dumps(errs)}")
    worst = max(e for case in errs.values() for e in case.values())
    if not worst <= K1_TOL:
        raise SystemExit(f"FAIL: K1 kernel differs from plain by {worst} > {K1_TOL}")
    k1_8 = time_k1(k1, *calls8["warp_twopass"][0], plain_iters=5)
    log(f"[k1] B=8 {json.dumps(k1_8)}")
    k1_128 = time_k1(k1, *warp128, plain_iters=2)
    log(f"[k1] B={bsz} {json.dumps(k1_128)}")
    log(f"[k1] B={bsz} warp_twopass {k1_128['ms']:.3f} ms (pass 1 {k1_128['pass1_ms']:.3f}, pass 2 "
        f"{k1_128['pass2_ms']:.3f}) against the function's bound {k1_128['bound_ms']:.3f} ms and the "
        f"two-kernel floor {k1_128['two_kernel_floor_ms']:.3f} ms; positions in memory + hat_resample "
        f"twice {k1_128['positions_route_ms']:.3f} ms (floor {k1_128['positions_route_floor_ms']:.3f}); "
        f"library_ms is grid_sample twice given the positions, {k1_128['library_ms']:.3f} ms "
        f"({k1_128['library_with_positions_ms']:.3f} with building them); a device-to-device copy "
        f"reaches {k1_128['copy_tb_per_s']:.2f} TB/s of the {HBM_BYTES_PER_S / 1e12:.2f} the bounds assume")
    del calls8, calls128, warp128

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
