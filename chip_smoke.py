"""Drive the PyTorch port of chessvision on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--profile]

(``--load-client``, ``--mesh-child`` and ``--cli-trainers`` are the
script's own child processes.)

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
   lite), with the card's name and power limit;
6. codecs: ``run_packed`` and ``run_yuv444`` on host-packed inputs must give
   the raw path's five outputs bit for bit, ``run_yuv`` the same ``found``
   flags; bytes per board of each format;
7. stream: ``run_stream`` over 6 batches of 128 for each input kind must
   yield the outputs of six separate calls, in order, with 2 K1 launches a
   batch; boards/s streamed and not;
8. yolo: the facade with the YOLO pair (committed weights) at batch 8;
9. server: the HTTP server on loopback with the micro-batcher in front of
   the engine: /ping, concurrent /cv_algo/ posts (each FEN must equal
   ``process_batch``'s), a flipped and an undecodable post, /feedback/,
   then the micro-batcher alone with boards; request latency and rate;
10. augment: both training augmentations with every flag on at the
   trainers' shapes (segmentation B=32 256², 4 K1 launches; classifier
   B=256 64², 2), each K1 call held against its plain version and timed
   beside its bounds and grid_sample;
11. train: ``train_unet.train_model`` (UNet base 32, B=32, guard_quad) and
   ``train_classifier.train_model`` (ResNet18 width 64, B=256), bfloat16,
   2 epochs, augment on, on a seeded synthetic dataset; checkpoints with
   the committed weights' keys and shapes, served by ``ChessVision``; then
   20 timed steps of each (step ms, images/s, FLOPs from the shapes);
12. eval: ``evaluate_model`` on 16 synthetic frames (aggregates equal
   ``process_batch``'s own and the plain K1's), ``evaluate_segmentation``;
13. parallel (``parallel/mesh.py``): (a) two processes on the one card over
   gloo (NCCL refuses two ranks on a device) each run one full-width train
   step of the UNet (B=32 global) and the ResNet18 (B=256 global) on its
   rows; loss, metric, parameter norm and BatchNorm statistics equal across
   the ranks and match the one-process step; step ms beside the one-process
   step's; (b) both trainers' command lines at world size 1 over NCCL,
   1 epoch each, rank 0's checkpoints served by ``ChessVision``; (c)
   ``Engine(mesh=…).process_batch`` at B=128 over two ranks equals phase
   4's one-process result (FENs, found, quads) on every rank;
14. data: 64 seeded 512² JPEG frames; the native loader built from
   ``native/cvloader`` (``load_batch`` against cv2, the yuv packers
   bit-identical to numpy, host packing ms at B=128), ``ingest.run_pipeline``
   against a table recomputed from ``process_batch`` (images/s), and
   ``curation.scan_image_issues``.

Phases 7–10 and 13–14 also record what their path hands K1 (a streamed batch of each
kind, the YOLO call, every batch the server's burst ran: batch 1 up to 16)
and hold the kernel against its plain version on those inputs; the
server's launches must be 2 for each batch the micro-batcher ran.

``--profile`` adds stage times (device stages and the host steps of
``process_batch``), the device's busy share, peak memory, how much of
``run_stream``'s upload time lies under kernels, and the device's busy
share and top ops over 3 train steps of each trainer.

Output: a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Needs no network.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
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


def check_captured(k1, calls: dict, where: str) -> dict:
    """``check_k1`` on every ``warp_twopass`` call that ``capture_k1``
    recorded on a path: {"<where> call i B=n": errors}.  The path must have
    gone through ``warp_twopass`` and never through ``hat_resample``."""
    if not calls["warp_twopass"] or calls["hat_resample"]:
        fail(f"{where}: expected warp_twopass calls only, got {({k: len(v) for k, v in calls.items()})}")
    errs = {}
    for i, args in enumerate(calls["warp_twopass"]):
        errs[f"{where} call {i} B={args[0].shape[0]}"] = check_k1(k1, *args)
    worst = max(e for case in errs.values() for e in case.values())
    if not worst <= K1_TOL:
        fail(f"{where}: K1 kernel differs from plain by {worst} > {K1_TOL}: {json.dumps(errs)}")
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


KEYS = ("logits", "quadrangle", "found", "board_image", "probabilities")


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def same_outputs(a: dict, b: dict) -> list[str]:
    """The keys on which two device output dicts differ in any bit."""
    import torch

    return [k for k in KEYS if not torch.equal(a[k], b[k])]


def fens_of(engine_mod, constants, out: dict) -> list[str]:
    """Validated FENs of a device output dict ("" where no board was found)."""
    probs = out["probabilities"].cpu().numpy()
    found = out["found"].cpu().numpy()
    names = constants.SQUARE_NAMES_NORMAL
    validated, _ = engine_mod.validate_labels_batch(probs, names)
    return engine_mod._fen_strings(probs, validated, found, names)[0]


def ppm_bytes(frame_bgr) -> bytes:
    """A uint8 BGR frame as a binary PPM: an encoding that needs no
    encoder here, is lossless, and that the server's cv2.imdecode reads."""
    h, w = frame_bgr.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode() + frame_bgr[:, :, ::-1].tobytes()


def http_json(port: int, path: str, payload: dict | None):
    """(status, body) of a GET (payload None) or a JSON POST on loopback."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def in_threads(jobs: list) -> list:
    """Run the callables at once, one thread each; their results in order."""
    import threading

    results = [None] * len(jobs)

    def run(i):
        results[i] = jobs[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        fail("a request thread did not finish")
    return results


def phase_codecs(engine, engine_mod, constants, frames8, soft8) -> None:
    """Packed and yuv444 inputs against the raw path, bit for bit; yuv's
    found flags; bytes per board."""
    n = len(frames8)
    packers = {"packed": engine_mod.pack_inputs, "yuv": engine_mod.pack_inputs_yuv,
               "yuv444": engine_mod.pack_inputs_yuv444}
    sizes = {"raw": frames8.nbytes // n}
    sizes.update({k: sum(a.nbytes for a in fn(frames8)) // n for k, fn in packers.items()})
    log(f"[codecs] bytes per 512x512 board, from the arrays: {json.dumps(sizes)}")
    for name, frames in (("synthetic", frames8), ("synthetic, chroma limited", soft8)):
        raw = engine.run_device(frames)
        diff = same_outputs(engine.run_packed(*packers["packed"](frames)), raw)
        log(f"[codecs] {name}: run_packed vs run_device differing outputs: {diff}")
        if diff:
            fail(f"run_packed differs from run_device on {diff}")
    # yuv444 is exact where the chroma differences fit int8: the limited
    # frames, as board photos; the flat clutter of the plain synthetic
    # frames takes any color, so there it is only reported
    raw_soft = engine.run_device(soft8)
    y, cb, cr, gres = packers["yuv444"](soft8)
    clipped = int(((cb == 0) | (cb == 255) | (cr == 0) | (cr == 255)).sum())
    diff = same_outputs(engine.run_yuv444(y, cb, cr, gres), raw_soft)
    log(f"[codecs] chroma limited: run_yuv444 vs run_device differing outputs: {diff} ({clipped} clipped chroma values)")
    if clipped or diff:
        fail(f"run_yuv444 differs from run_device on {diff} ({clipped} clipped)")
    raw = engine.run_device(frames8)
    raw_fens = fens_of(engine_mod, constants, raw)
    y, cb, cr, gres = packers["yuv444"](frames8)
    out444 = engine.run_yuv444(y, cb, cr, gres)
    clipped = int(((cb == 0) | (cb == 255) | (cr == 0) | (cr == 255)).sum())
    agree = sum(a == b for a, b in zip(fens_of(engine_mod, constants, out444), raw_fens))
    log(f"[codecs] synthetic (saturated clutter, {clipped} clipped chroma values): run_yuv444 FENs equal "
        f"run_device's on {agree}/{n}")
    for name, frames, ref in (("synthetic", frames8, raw), ("synthetic, chroma limited", soft8, raw_soft)):
        out = engine.run_yuv(*packers["yuv"](frames))
        agree = sum(a == b for a, b in zip(fens_of(engine_mod, constants, out), fens_of(engine_mod, constants, ref)))
        same_found = bool((out["found"] == ref["found"]).all())
        log(f"[codecs] {name}: run_yuv found equal={same_found}, FENs equal the packed path's on {agree}/{n}")
        if not same_found:
            fail("run_yuv gives other found flags than the packed path")


def phase_stream(engine, engine_mod, k1, frames128, profile: bool) -> tuple[int, dict]:
    """run_stream against six separate calls for each input kind; returns
    the K1 launches of the streamed runs that were counted, and K1's errors
    against its plain version on the inputs a streamed batch of each kind
    gave it."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import profiling

    n_batches, bsz = 6, len(frames128)
    batches = [np.roll(frames128, 5 * i, axis=0) for i in range(n_batches)]
    kinds = {
        "raw": (lambda f: (f,), engine.run_device),
        "packed": (engine_mod.pack_inputs, engine.run_packed),
        "yuv": (engine_mod.pack_inputs_yuv, engine.run_yuv),
        "yuv444": (engine_mod.pack_inputs_yuv444, engine.run_yuv444),
    }
    counted, errs = 0, {}
    for kind, (pack, run) in kinds.items():
        t0 = time.perf_counter()
        packed = [pack(b) for b in batches]
        pack_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        elements = [p[0] for p in packed] if kind == "raw" else packed

        def separate():
            return [run(*p) for p in packed]

        def streamed():
            return list(engine.run_stream(iter(elements), kind=kind))

        want = separate()
        # warm-up (pinned buffers, copy stream), with K1's arguments recorded
        _, calls = capture_k1(k1, lambda: list(engine.run_stream(iter(elements[:2]), kind=kind)))
        torch.cuda.synchronize()
        calls["warp_twopass"] = calls["warp_twopass"][1:]  # the second batch: uploaded under the first
        errs.update(check_captured(k1, calls, f"run_stream {kind}"))
        del calls
        k1.launches = 0
        got = streamed()
        torch.cuda.synchronize()
        launches = k1.launches
        counted += launches
        if launches != 2 * n_batches:
            fail(f"run_stream kind={kind}: expected {2 * n_batches} K1 launches, got {launches}")
        if len(got) != n_batches:
            fail(f"run_stream kind={kind} yielded {len(got)} of {n_batches} batches")
        for i, (g, w) in enumerate(zip(got, want)):
            diff = same_outputs(g, w)
            if diff:
                fail(f"run_stream kind={kind} batch {i} differs from the separate call on {diff}")
        del got, want
        times = {"separate": [], "streamed": []}
        for name, fn in (("separate", separate), ("streamed", streamed), ("streamed", streamed), ("separate", separate)):
            times[name] += profiling.wall_ms(fn, iters=1)
        rate = {k: [round(n_batches * bsz * 1e3 / t, 1) for t in v] for k, v in times.items()}
        log(f"[stream] kind={kind}: {n_batches} batches of {bsz} equal the separate calls, K1 launches {launches}; "
            f"boards/s streamed {rate['streamed']} against separate calls with pageable uploads {rate['separate']} "
            f"(ms: {json.dumps({k: [round(t, 2) for t in v] for k, v in times.items()})}); "
            f"host packing {pack_ms:.2f} ms a batch, not in either")
        if profile:
            with tempfile.TemporaryDirectory() as tmp, profiling.trace(tmp) as prof:
                list(engine.run_stream(iter(elements[:4]), kind=kind))
            log(f"[stream] kind={kind} profiled over 4 batches: {json.dumps(profiling.upload_overlap(prof))}")
    return counted, errs


def phase_yolo(k1, frames8) -> tuple[int, dict]:
    """The facade with the YOLO pair at batch 8; returns K1's launches and
    its errors against its plain version on that call's inputs."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.core import ChessVision

    cv = ChessVision(board_extractor_model_id="yolo", classifier_model_id="yolo", device="cuda")
    engine = cv.engine
    if not (isinstance(cv.board_extractor[0], models.YoloSeg) and isinstance(cv.classifier[0], models.YoloCls)):
        fail("the yolo ids did not build the YOLO models")
    engine.process_batch(frames8)  # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    res, calls = capture_k1(k1, lambda: engine.process_batch(frames8))
    torch.cuda.synchronize()
    launches = k1.launches
    errs = check_captured(k1, calls, "yolo")
    del calls
    lite = engine.process_batch(frames8, lite=True)
    log(f"[yolo] process_batch B=8 found={int(res.board_found.sum())}/8 fens={res.fens}; K1 launches {launches}")
    if launches != 2:
        fail(f"yolo: expected 2 K1 launches, got {launches}")
    if not (res.probabilities.shape == (8, 64, 13) and np.isfinite(res.probabilities).all()):
        fail("yolo: probabilities not finite (8, 64, 13)")
    if not np.isfinite(res.logits).all() or res.logits.shape != (8, 256, 256):
        fail("yolo: logits not finite (8, 256, 256)")
    if lite.fens != res.fens:
        fail("yolo: lite FENs differ from full FENs")
    cv32 = ChessVision(board_extractor_model_id="yolo", classifier_model_id="yolo", device="cuda", dtype=torch.float32)
    res32 = cv32.engine.process_batch(frames8)
    agree = sum(a == b for a, b in zip(res32.fens, res.fens))
    log(f"[yolo] f32: found equal={bool((res32.board_found == res.board_found).all())}, "
        f"FENs equal bf16 vs f32: {agree}/8")
    frames128 = np.concatenate([frames8] * 16)
    from chessvision_tpu_torch import profiling

    t = profiling.wall_ms(engine.process_batch, frames128, iters=5, warmup=1)
    one = profiling.wall_ms(engine.process_batch, frames8[:1], iters=20, warmup=2)
    log(f"[yolo] B=128 bf16 process_batch median {percentile(t, 0.5):.2f} ms -> "
        f"{128e3 / percentile(t, 0.5):.1f} boards/s; B=1 p50 {percentile(one, 0.5):.2f} ms")
    return launches, errs


def load_client(port: int, bodies_path: str) -> int:
    """The server phase's load generator, run as a process of its own so
    that its threads do not share the server's interpreter lock: 20 posts
    one at a time, then 4 rounds of 16 at once, cycling through the JSON
    bodies in ``bodies_path``.  Prints one JSON line of latencies (ms) and
    rates; imports the standard library only."""
    import urllib.request

    with open(bodies_path, "rb") as f:
        bodies = [json.dumps(b).encode() for b in json.load(f)]

    def post(i: int) -> float:
        t = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/cv_algo/", data=bodies[i % len(bodies)],
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            if not json.loads(resp.read())["success"]:
                raise SystemExit("a post was refused")
        return (time.perf_counter() - t) * 1e3

    one_by_one = [post(i) for i in range(20)]
    rounds = []
    for _ in range(4):
        t = time.perf_counter()
        lat = in_threads([lambda i=i: post(i) for i in range(16)])
        rounds.append({"requests_per_s": 16 / (time.perf_counter() - t), "p50_ms": percentile(lat, 0.5)})
    print(json.dumps({"one_by_one_ms": one_by_one, "rounds": rounds}))
    return 0


class HoldFirst:
    """An engine whose first ``process_batch`` waits to be released, so that
    later submits queue up behind it and are coalesced into one batch."""

    def __init__(self, engine) -> None:
        import threading

        self.engine = engine
        self.release = threading.Event()
        self.sizes: list[int] = []

    def process_batch(self, imgs, **kw):
        self.sizes.append(len(imgs))
        if len(self.sizes) == 1:
            self.release.wait(120)
        return self.engine.process_batch(imgs, **kw)


def phase_server(k1, frames8) -> tuple[int, dict]:
    """The HTTP server and the micro-batcher on the card; returns K1's
    launches over the burst of requests and its errors against its plain
    version on the inputs every batch of that burst gave it."""
    import base64
    import shutil
    import threading
    from pathlib import Path

    import numpy as np
    import torch

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.serve.server import _MicroBatcher, serve

    cv = ChessVision(device="cuda", lazy_load=False)
    engine = cv.engine
    batches: list[int] = []  # the sizes of the batches that the micro-batcher hands the engine
    process_batch = engine.process_batch

    def counting(imgs, **kw):
        batches.append(len(imgs))
        return process_batch(imgs, **kw)

    upload_root = tempfile.mkdtemp(prefix="cv_uploads_")
    engine.process_batch = counting
    t0 = time.perf_counter()
    server = serve(port=0, local=True, cv_model=cv, upload_root=upload_root, warmup=True)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log(f"[server] up on loopback port {port}, warmed batch sizes 1..16 in {time.perf_counter() - t0:.1f} s")
    try:
        status, body = http_json(port, "/ping", None)
        if (status, body) != (200, {"status": "ok"}):
            fail(f"/ping answered {status} {body}")
        if batches != [1, 2, 4, 8, 16]:
            fail(f"the warm-up ran batches {batches}, expected [1, 2, 4, 8, 16]")
        want = process_batch(frames8, lite=True)
        want_flip = process_batch(frames8[:1], flip=True, lite=True)
        posts = [{"image": base64.b64encode(ppm_bytes(f)).decode()} for f in frames8]
        posts.append({**posts[0], "flip": True})
        posts.append({"image": base64.b64encode(b"not an image").decode()})
        expect = [(f, bool(ok)) for f, ok in zip(want.fens, want.board_found)]
        expect.append((want_flip.fens[0], bool(want_flip.board_found[0])))

        def timed_post(payload):
            t = time.perf_counter()
            status, body = http_json(port, "/cv_algo/", payload)
            return status, body, (time.perf_counter() - t) * 1e3

        batches.clear()
        k1.launches = 0
        answers, calls = capture_k1(k1, lambda: in_threads([lambda p=p: timed_post(p) for p in posts]))
        torch.cuda.synchronize()
        launches = k1.launches
        burst = list(batches)
        # 9 decodable posts in two groups (flipped or not), each padded to a power of two
        if not burst or sum(burst) < 9 or any(b & (b - 1) for b in burst):
            fail(f"the burst ran as batches {burst}")
        if launches != 2 * len(burst) or [a[0].shape[0] for a in calls["warp_twopass"]] != burst:
            fail(f"the burst ran as batches {burst}: expected {2 * len(burst)} K1 launches, got {launches}; "
                 f"warp_twopass saw {[a[0].shape[0] for a in calls['warp_twopass']]}")
        errs = check_captured(k1, calls, "server")
        del calls
        for i, ((fen, found), (status, body, _)) in enumerate(zip(expect, answers)):
            if found and not (status == 200 and body["success"] and body["fen"] == body["FEN"] == fen
                              and len(body["confidence_scores"]) == 64):
                fail(f"/cv_algo/ post {i}: {status} {body.get('fen')!r}, process_batch gave {fen!r}")
            if not found and not (status == 400 and body["error"] == "No chessboard detected"):
                fail(f"/cv_algo/ post {i}: {status} {body}, process_batch found no board")
        status, body, _ = answers[-1]
        if status != 400 or "Invalid image" not in body["error"]:
            fail(f"undecodable post answered {status} {body}")
        ok = sum(status == 200 for status, _, _ in answers)
        log(f"[server] {len(posts)} concurrent posts: {ok} answered 200 with process_batch's FEN (one flipped), "
            f"{len(posts) - ok - 1} no-board 400, 1 undecodable 400; batches {burst}, K1 launches {launches}")
        status, body = http_json(port, "/feedback/", {"id": answers[0][1].get("id", "x"), "position": {"a1": "R"}})
        stored = [json.loads(p.read_text()) for p in (Path(upload_root) / "feedback").glob("*.json")]
        if status != 200 or len(stored) != 1 or stored[0]["position"] != {"a1": "R"}:
            fail(f"/feedback/ answered {status} {body}, stored {stored}")
        if http_json(port, "/feedback/", {"position": {}})[0] != 400:
            fail("/feedback/ without an id was not refused")
        bodies_path = os.path.join(upload_root, "bodies.json")
        with open(bodies_path, "w") as f:
            json.dump([p for p, (_, found) in zip(posts[:8], expect) if found], f)
        client = subprocess.run([sys.executable, os.path.abspath(__file__), "--load-client", str(port), bodies_path],
                                capture_output=True, text=True, timeout=600)
        if client.returncode != 0:
            fail(f"the load client failed: {client.stdout[-2000:]} {client.stderr[-2000:]}")
        load = json.loads(client.stdout.strip().splitlines()[-1])
        one_by_one = load["one_by_one_ms"]
        log(f"[server] load from a client process: one request at a time p50 {percentile(one_by_one, 0.5):.2f} ms, "
            f"p90 {percentile(one_by_one, 0.9):.2f} ms -> {1e3 / percentile(one_by_one, 0.5):.1f} requests/s; "
            f"16 at once, 4 rounds: requests/s {[round(r['requests_per_s'], 1) for r in load['rounds']]}, "
            f"request p50 ms {[round(r['p50_ms'], 2) for r in load['rounds']]}")
    finally:
        server.shutdown()
        server.server_close()
        shutil.rmtree(upload_root, ignore_errors=True)
        del engine.process_batch  # the counting wrapper; the method is back

    # the micro-batcher alone, in the persisting mode's shape: boards come back
    held = HoldFirst(engine)
    batcher = _MicroBatcher(held, include_board=True)
    first = threading.Thread(target=batcher.submit, args=(frames8[7], False))
    first.start()
    deadline = time.time() + 60
    while not held.sizes and time.time() < deadline:
        time.sleep(0.005)
    results: dict[int, tuple] = {}
    threads = []
    for i in range(5):  # queued one after the other, so the batch's order is known
        th = threading.Thread(target=lambda i=i: results.update({i: batcher.submit(frames8[i], False)}))
        th.start()
        threads.append(th)
        while batcher.q.qsize() <= i and time.time() < deadline:
            time.sleep(0.005)
    held.release.set()
    for th in [first, *threads]:
        th.join(timeout=300)
    if held.sizes != [1, 8] or sorted(results) != list(range(5)):
        fail(f"micro-batcher: batches {held.sizes}, answers {sorted(results)}; expected [1, 8] and 5 answers")
    padded = np.concatenate([frames8[:5], np.repeat(frames8[4:5], 3, axis=0)])
    ref = engine.process_batch(padded, lite=True, include_board=True)
    for i in range(5):
        found, fen, conf, board = results[i]
        if found != bool(ref.board_found[i]) or fen != ref.fens[i]:
            fail(f"micro-batcher submit {i}: found/FEN differ from process_batch")
        if found and not np.array_equal(board, ref.board_image[i]):
            fail(f"micro-batcher submit {i}: board differs from process_batch(...).board_image")
    log(f"[server] micro-batcher alone: 5 submits behind a held one ran as batches {held.sizes}; found, FENs and "
        f"boards equal process_batch's")
    return launches, errs


# -- 10–12. augmentation, training and evaluation --------------------------------------------


def seg_batch(seed: int, b: int, size: int = 256):
    """(b, size, size, 3) float32 synthetic frames in [0, 1] and their
    (b, size, size) board masks, on the card."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.synthetic import board_frame, quad_mask

    rng = np.random.default_rng(seed)
    pairs = [board_frame(rng, size) for _ in range(b)]
    imgs = np.stack([p[0] for p in pairs]).astype(np.float32) / 255.0
    masks = np.stack([quad_mask(p[1], size) for p in pairs]).astype(np.float32) / 255.0
    return torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()


def cls_batch(seed: int, b: int):
    """(b, 64, 64, 1) float32 synthetic squares in [0, 1] and their labels,
    on the card."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.synthetic import SQUARE_CLASS_DIRS, square_crop

    rng = np.random.default_rng(seed)
    labels = np.arange(b) % len(SQUARE_CLASS_DIRS)
    crops = np.stack([square_crop(rng, SQUARE_CLASS_DIRS[c]) for c in labels]).astype(np.float32) / 255.0
    return torch.from_numpy(crops[..., None]).cuda(), torch.from_numpy(labels).cuda()


def phase_augment(k1, seed: int) -> tuple[int, dict, dict]:
    """Both augmentations with every flag on, at the trainers' shapes: the
    segmentation batch (B=32, 256²: the images' 96 planes and the masks' 32
    in two K1 calls) and the classifier batch (B=256, 64²: one call).  Every
    call is held against the plain version and timed beside its bounds and
    grid_sample.  Returns the launches, the errors and the times."""
    import torch

    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch

    imgs, masks = seg_batch(seed, 32)
    squares, _ = cls_batch(seed, 256)
    augment_segmentation_batch(seed, imgs, masks, illum_gradient=True)  # warm-up
    augment_classification_batch(seed, squares, cutout=True, dim=True, fade=True)
    torch.cuda.synchronize()
    k1.launches = 0
    (seg_out, mask_out), seg_calls = capture_k1(
        k1, lambda: augment_segmentation_batch(seed + 1, imgs, masks, illum_gradient=True))
    torch.cuda.synchronize()
    seg_launches = k1.launches
    k1.launches = 0
    cls_out, cls_calls = capture_k1(
        k1, lambda: augment_classification_batch(seed + 1, squares, cutout=True, dim=True, fade=True))
    torch.cuda.synchronize()
    cls_launches = k1.launches
    log(f"[augment] K1 launches: segmentation B=32 {seg_launches}, classifier B=256 {cls_launches}")
    if seg_launches != 4 or cls_launches != 2:
        fail(f"augment: expected 4 and 2 K1 launches, got {seg_launches} and {cls_launches}")
    for name, t, lo, hi in (("images", seg_out, 0.0, 1.0), ("masks", mask_out, 0.0, 1.0), ("squares", cls_out, 0.0, 1.0)):
        if not (torch.isfinite(t).all() and t.min() >= lo - 1e-6 and t.max() <= hi + 1e-6):
            fail(f"augment: {name} not finite in [{lo}, {hi}]")
    if seg_out.shape != imgs.shape or mask_out.shape != masks.shape or cls_out.shape != squares.shape:
        fail("augment: output shapes differ from the inputs'")
    errs = {**check_captured(k1, seg_calls, "augment segmentation"), **check_captured(k1, cls_calls, "augment classifier")}
    times = {
        "segmentation": [time_k1(k1, *args, plain_iters=2) for args in seg_calls["warp_twopass"]],
        "classifier": [time_k1(k1, *args, plain_iters=2) for args in cls_calls["warp_twopass"]],
    }
    for name, rows in times.items():
        total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "two_kernel_floor_ms")}
        times[name] = {"calls": rows, **total}
        log(f"[augment] K1 at the {name} shapes {[r['shape'] for r in rows]}: {total['ms']:.4f} ms over "
            f"{len(rows)} call(s) against the function's bound {total['bound_ms']:.4f} ms and the two-kernel "
            f"floor {total['two_kernel_floor_ms']:.4f} ms; plain {total['plain_ms']:.3f} ms; grid_sample twice "
            f"(cuDNN off, positions given) {total['library_ms']:.4f} ms")
    return seg_launches + cls_launches, errs, times


def conv_flops(model, x) -> float:
    """Multiply-adds ×2 of every convolution and linear layer in one forward
    of ``model`` on ``x``, from the shapes."""
    import torch
    from torch import nn

    total = [0.0]

    def hook(m, inp, out):
        if isinstance(m, nn.ConvTranspose2d):
            total[0] += 2.0 * inp[0].numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1] / m.groups
        elif isinstance(m, nn.Conv2d):
            total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def same_keys_and_shapes(path: str, reference: str) -> list[str]:
    """Keys whose presence or shape differ between two checkpoints, apart
    from the optimizer leaves and the metadata."""
    import numpy as np

    def shapes(p):
        with np.load(p) as d:
            return {k: d[k].shape for k in d.files if not (k.startswith("opt_state/") or k == "__metadata__")}

    a, b = shapes(path), shapes(reference)
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def time_train_steps(k1, kind: str, seed: int, profile: bool = False) -> dict:
    """20 train steps at the trainers' configuration on device-resident
    batches, augmentation included and one host sync a step (the loss), as
    the trainers run: step ms, images/s and K1 launches a step; with
    ``profile``, the device's busy share over 3 more steps and the top ops."""
    import torch

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.train import steps
    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch, fold_in

    torch.manual_seed(seed)
    if kind == "unet":
        model = models.UNet(base=32)
        imgs, targets = seg_batch(seed, 32)
        tx = steps.Chain([steps.ClipByGlobalNorm(1.0), steps.AddDecayedWeights(1e-8),
                          steps.inject_hyperparams(steps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
        train_step = steps.make_seg_train_step()

        def batch(i):
            return augment_segmentation_batch(fold_in(seed, i), imgs, targets)
    else:
        model = models.resnet18(width=64)
        imgs, targets = cls_batch(seed, 256)
        tx = steps.adam(steps.exponential_decay(1e-3, 16, 0.1, staircase=True))
        train_step = steps.make_cls_train_step()

        def batch(i):
            return augment_classification_batch(fold_in(seed, i), imgs), targets

    model = set_compute_dtype(model, torch.bfloat16, master_weights=True).cuda()
    state = steps.TrainState.create(model, tx)
    for i in range(3):  # warm-up: cuDNN algorithm choice
        train_step(state, *batch(i))["loss"].item()
    torch.cuda.synchronize()
    iters = 20
    k1.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(iters):
        losses.append(train_step(state, *batch(3 + i))["loss"].item())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    launches = k1.launches
    flops_fwd = conv_flops(model, imgs[:1]) * imgs.shape[0]
    b = imgs.shape[0]
    res = {
        "kind": kind, "batch": b, "shape": list(imgs.shape), "step_ms": step_ms, "images_per_s": b * 1e3 / step_ms,
        "k1_launches_per_step": launches / iters, "train_flops_per_step": 3 * flops_fwd,
        "tflops_per_s": 3 * flops_fwd / step_ms / 1e9, "bf16_peak_share": 3 * flops_fwd / step_ms / 1e9 / 989.0,
        "first_loss": losses[0], "last_loss": losses[-1],
    }
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        fail(f"train timing {kind}: loss not finite")
    if profile:
        from chessvision_tpu_torch import profiling

        def three_steps():
            for i in range(3):
                train_step(state, *batch(100 + i))["loss"].item()

        busy, wall, table = profiling.device_busy(three_steps)
        res["profile_busy_ms"], res["profile_wall_ms"] = busy, wall
        log(f"[train] {kind} 3 steps under the profiler: device busy {busy:.2f} ms of {wall:.2f} ms wall "
            f"({100 * busy / wall:.1f}%), top ops by device time\n{table}")
    return res


def phase_train(k1, seed: int, root: str, frames8, profile: bool = False) -> tuple[int, dict]:
    """Both trainers through ``train_model`` at the shipping widths on a
    seeded synthetic dataset (UNet base 32, B=32, 256², guard_quad, and
    ResNet18 width 64, B=256, 64², both bfloat16, 2 epochs, augment on);
    their checkpoints must have the committed weights' keys and shapes and
    serve through ``ChessVision``.  Then 20 timed steps of each."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import write_segmentation_dataset, write_squares_dataset
    from chessvision_tpu_torch.train import data as data_lib
    from chessvision_tpu_torch.train import train_classifier, train_unet

    data_root = os.path.join(root, "data")
    os.environ["CVTPU_DATA_ROOT"] = data_root
    os.environ["CVTPU_STORE_ROOT"] = os.path.join(root, "store")
    t0 = time.perf_counter()
    write_segmentation_dataset(data_root, 96, seed)
    write_squares_dataset(data_root, 80, 20, seed)
    log(f"[train] wrote 96 boards and {13 * 100} squares in {time.perf_counter() - t0:.1f} s")

    results = {}
    launches_total = 0
    for kind, fn, kwargs, reference, per_step in (
        ("unet", train_unet.train_model,
         dict(epochs=2, batch_size=32, base=32, augment=True, guard_quad=True), constants.BEST_EXTRACTOR_WEIGHTS, 4),
        ("resnet18", train_classifier.train_model,
         dict(epochs=2, batch_size=256, width=64, augment=True), constants.BEST_CLASSIFIER_WEIGHTS, 2),
    ):
        k1.launches = 0
        t0 = time.perf_counter()
        run, ckpt = fn(run_name=f"smoke-{kind}", model_dtype=torch.bfloat16, device="cuda", seed=seed, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.launches
        launches_total += launches
        scalars = run.scalars()
        train_losses = [s["train_loss"] for s in scalars if "train_loss" in s]
        n_train = len(data_lib.load_board_extraction().train_images) if kind == "unet" else 13 * 80
        n_steps = 2 * (n_train // kwargs["batch_size"])
        log(f"[train] {kind}: train_model 2 epochs in {wall:.1f} s, {n_steps} steps, train losses {train_losses}, "
            f"best {run.parameters['best_val_score']}, K1 launches {launches}; checkpoint {ckpt}")
        if len(train_losses) != 2 or not np.isfinite(train_losses).all():
            fail(f"train {kind}: losses not finite: {scalars}")
        if launches != per_step * n_steps:
            fail(f"train {kind}: expected {per_step} K1 launches a step ({per_step * n_steps}), got {launches}")
        diff = same_keys_and_shapes(ckpt, reference)
        if diff:
            fail(f"train {kind}: checkpoint keys/shapes differ from {reference}: {diff}")
        if not run.list_metrics_tables():
            fail(f"train {kind}: no metrics table collected")
        results[kind] = {"wall_s": wall, "steps": n_steps, "train_losses": train_losses, "checkpoint": ckpt}

    cv = ChessVision(board_extractor_weights=results["unet"]["checkpoint"],
                     classifier_weights=results["resnet18"]["checkpoint"], device="cuda")
    k1.launches = 0
    res = cv.engine.process_batch(frames8)
    launches_total += k1.launches
    if not (res.probabilities.shape == (8, 64, 13) and np.isfinite(res.probabilities).all()
            and np.isfinite(res.logits).all()):
        fail("train: the trained checkpoints do not serve finite outputs")
    log(f"[train] ChessVision on the trained checkpoints, B=8: found {int(res.board_found.sum())}/8")

    for kind in ("unet", "resnet18"):
        t = time_train_steps(k1, kind, seed, profile)
        launches_total += int(t["k1_launches_per_step"] * 20)
        if t["k1_launches_per_step"] != (4 if kind == "unet" else 2):
            fail(f"train timing {kind}: K1 launches a step {t['k1_launches_per_step']}")
        results[kind]["timing"] = t
        log(f"[train] {kind} B={t['batch']} {t['shape']} bf16: {t['step_ms']:.2f} ms a step (augment + "
            f"forward + backward + update + one loss sync), {t['images_per_s']:.1f} images/s; "
            f"{t['train_flops_per_step'] / 1e9:.1f} GFLOP a step (3x forward) -> {t['tflops_per_s']:.1f} "
            f"TFLOP/s, {100 * t['bf16_peak_share']:.1f}% of the 989 bf16 peak; loss {t['first_loss']:.4f} -> "
            f"{t['last_loss']:.4f}")
    return launches_total, results


def phase_eval(k1, seed: int, root: str) -> int:
    """``evaluate_model`` on 16 synthetic frames with the committed weights:
    its aggregates must equal those computed from ``process_batch`` on the
    same frames, and those with K1 swapped for its plain version.  Then
    ``evaluate_segmentation`` on the synthetic val split (from the train
    phase).  Returns K1's launches."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import runstore
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval import evaluate as ev
    from chessvision_tpu_torch.synthetic import write_test_root

    test_root = write_test_root(os.path.join(root, "test"), 16, seed)
    cv = ChessVision(device="cuda")
    k1.launches = 0
    agg = ev.evaluate_model(cv_model=cv, test_root=test_root, include_metrics_table=True, batch_size=8,
                            run=runstore.init("chessvision-testing", "smoke-eval"))
    torch.cuda.synchronize()
    launches = k1.launches
    log(f"[eval] evaluate_model 16 frames: {json.dumps(agg)}; K1 launches {launches}")
    if launches != 6:
        fail(f"eval: expected 6 K1 launches (2 batches of 8 + 1 warm re-dispatch), got {launches}")

    items = list(ev.get_test_generator(test_root))
    imgs = np.stack([im for im, _, _ in items])
    want = {"extraction_failures": 0, "validation_fixes": 0, "validation_improvements": 0, "num_images": len(items)}
    sums = {"top_1_accuracy": 0.0, "top_1_accuracy_validated": 0.0, "top_2_accuracy": 0.0, "top_3_accuracy": 0.0}
    for start in range(0, len(items), 8):
        res = cv.engine.process_batch(imgs[start : start + 8])
        for bi, (_, _, fen) in enumerate(items[start : start + 8]):
            if not res.board_found[bi]:
                want["extraction_failures"] += 1
                continue
            orig = ev.compute_position_accuracy(res.original_fens[bi], fen)
            val = ev.compute_position_accuracy(res.fens[bi], fen)
            topk = ev.compute_model_topk_accuracy(res.probabilities[bi], fen, k=3)
            sums["top_1_accuracy"] += topk.top_1
            sums["top_2_accuracy"] += topk.top_2
            sums["top_3_accuracy"] += topk.top_3
            sums["top_1_accuracy_validated"] += val.accuracy
            want["validation_fixes"] += len(res.validation_fixes[bi])
            want["validation_improvements"] += int(val.accuracy > orig.accuracy)
    n = max(len(items) - want["extraction_failures"], 1)
    want.update({k: v / n for k, v in sums.items()})
    got = {k: agg[k] for k in want}
    if got != want:
        fail(f"eval: evaluate_model aggregates {got} differ from process_batch's {want}")
    timeless = lambda a: {k: v for k, v in a.items() if not k.startswith("avg_time")}  # noqa: E731
    agg_plain = with_plain_k1(k1, lambda: ev.evaluate_model(cv_model=cv, test_root=test_root, batch_size=8,
                                                            run=runstore.init("chessvision-testing", "smoke-eval-plain")))
    if timeless(agg_plain) != timeless(agg):
        fail(f"eval: aggregates with the plain K1 differ: {timeless(agg_plain)} vs {timeless(agg)}")
    seg = ev.evaluate_segmentation(cv_model=cv, run=runstore.init("chessvision-testing", "smoke-seg"))
    log(f"[eval] aggregates equal process_batch's and the plain K1's; evaluate_segmentation on the synthetic "
        f"val split: {json.dumps(seg)}")
    if not (0.0 <= seg["val_mask_dice"] <= 1.0 and 0.0 <= seg["val_mask_iou"] <= 1.0):
        fail("eval: segmentation metrics out of [0, 1]")
    return launches


# two ranks against one process.  float32 (TF32 off): the CPU test's bounds
# (tests/test_torch_mesh.py).  bfloat16 keeps 8 significant bits (2^-8 =
# 3.9e-3 a rounding) and cuDNN picks its algorithms by the batch (16 or 128
# rows a rank, 32 or 256 in one process), so an output element may round
# one step apart: bounds a few times over the differences measured on an
# H100 (loss 1.2e-4, statistics 2.1e-4, parameter norm 6.2e-6)
MESH_TOL = {
    "float32": {"loss": 1e-6, "metric": 1e-6, "param_norm": 1e-6, "stats": 1e-5},
    "bfloat16": {"loss": 1e-3, "metric": 1e-2, "param_norm": 1e-4, "stats": 2e-3},
}


def child_env() -> dict:
    """The environment of the script's own child processes: the checkout
    on the path, collectives over loopback."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "CVTPU_DISTRIBUTED"):
        env.pop(v, None)
    return env


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(argvs: list[list[str]], timeout: int) -> list[str]:
    """Run this script's child modes at once; fail unless all exit 0.
    Every child is stopped before this returns."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *a], env=child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for a in argvs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for a, proc, out in zip(argvs, procs, outs):
        if proc.returncode != 0:
            fail(f"child {a[:2]} exited {proc.returncode}:\n{out[-4000:]}")
    return outs


def parity_steps(k1, mesh, seed: int, timed: int = 5) -> dict:
    """One train step of each trainer's model at full width (UNet base 32 on
    B=32 global 256² frames, ResNet18 width 64 on B=256 global squares),
    in bfloat16 over float32 master weights and in float32 (TF32 off), from
    the seeded state, on this rank's rows of the augmented global batch
    (every rank augments the whole batch, as the trainers do).  Records
    loss, metric, parameter norm and BatchNorm statistics after the step,
    K1's launches and its error against the plain version on the
    augmentation, then the ms of ``timed`` more bfloat16 steps
    (collectives included)."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.train import steps
    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch, fold_in
    from chessvision_tpu_torch.utils import full_f32

    out = {}
    for kind, dtype in (("unet", torch.bfloat16), ("resnet18", torch.bfloat16), ("unet", torch.float32),
                        ("resnet18", torch.float32)):
        name = f"{kind} {str(dtype).split('.')[-1]}"
        torch.manual_seed(seed)
        if kind == "unet":
            model = models.UNet(base=32)
            imgs, targets = seg_batch(seed, 32)
            tx = steps.Chain([steps.ClipByGlobalNorm(1.0), steps.AddDecayedWeights(1e-8),
                              steps.inject_hyperparams(steps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
            step, metric = steps.make_seg_train_step(mesh), "dice"

            def augment(i):
                return augment_segmentation_batch(fold_in(seed, i), imgs, targets)
        else:
            model = models.resnet18(width=64)
            imgs, targets = cls_batch(seed, 256)
            tx = steps.adam(1e-3)
            step, metric = steps.make_cls_train_step(mesh), "accuracy"

            def augment(i):
                return augment_classification_batch(fold_in(seed, i), imgs), targets

        model = mesh_lib.replicate(mesh, set_compute_dtype(model, dtype, master_weights=True).cuda())
        state = steps.TrainState.create(model, tx)
        k1.launches = 0
        (x, y), calls = capture_k1(k1, lambda: augment(0))
        torch.cuda.synchronize()
        launches = k1.launches
        errs = check_captured(k1, calls, f"parallel {name} augmentation")
        with full_f32():
            m = step(state, mesh_lib.local_rows(mesh, x), mesh_lib.local_rows(mesh, y))
        stats = [b.detach().double().cpu().numpy().ravel() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        out[name] = {
            "loss": float(m["loss"]), "metric": float(m[metric]),
            "param_norm": float(np.sqrt(sum(float(torch.sum(p.detach().double() ** 2)) for p in state.params))),
            "stats": np.concatenate(stats).tolist(), "k1_launches": launches,
            "k1_err": max(e for case in errs.values() for e in case.values()),
        }
        if dtype == torch.float32:
            continue
        xs, ys = mesh_lib.local_rows(mesh, x), mesh_lib.local_rows(mesh, y)
        step(state, xs, ys)["loss"].item()  # warm-up at the second step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            step(state, xs, ys)["loss"].item()
        torch.cuda.synchronize()
        out[name]["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
    return out


def mesh_child(rank: int, world: int, port: int, out_dir: str, seed: int) -> int:
    """One rank of phase 13: gloo on the one card (NCCL refuses two ranks on
    a device; gloo's collectives go through host memory).  (a) the parity
    steps, (c) ``Engine(mesh=…).process_batch`` at B=128 with the committed
    weights.  Writes ``rank{rank}.json``."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.synthetic import board_frames

    mesh_lib.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = mesh_lib.create_mesh(device="cuda")
    rec = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device), "backend": mesh.backend}
    rec["steps"] = parity_steps(k1, mesh, seed)

    uniq = board_frames(seed + 1, 32)[0]
    frames128 = np.concatenate([uniq] * 4)
    cv = ChessVision(device="cuda", mesh=mesh)
    cv.engine.process_batch(frames128)  # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    res, calls = capture_k1(k1, lambda: cv.engine.process_batch(frames128))
    torch.cuda.synchronize()
    rec["engine_ms"] = (time.perf_counter() - t0) * 1e3
    rec["engine_k1_launches"] = k1.launches
    errs = check_captured(k1, calls, "parallel engine")
    rec["engine_k1_err"] = max(e for case in errs.values() for e in case.values())
    rec["engine_rows"] = [int(a.shape[0]) for a in calls["warp_twopass"][0][:1]]
    rec["fens"], rec["found"] = list(res.fens), res.board_found.tolist()
    np.save(os.path.join(out_dir, f"quads{rank}.npy"), res.quadrangle)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def cli_trainers_child(root: str, port: int, out_dir: str, seed: int) -> int:
    """Phase 13(b): both trainers through their own command lines at world
    size 1 over NCCL (``--coordinator/--num-processes/--process-id``), one
    epoch on phase 11's dataset, K1 captured and held against its plain
    version on one batch of each."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.train import train_classifier, train_unet

    os.environ["CVTPU_DATA_ROOT"] = os.path.join(root, "data")
    os.environ["CVTPU_STORE_ROOT"] = os.path.join(root, "store")
    cluster = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"]
    common = ["--epochs", "1", "--skip-eval", "--seed", str(seed)]
    rec = {}
    for kind, main_fn, argv in (
        ("unet", train_unet.main, ["--base", "32", "--batch-size", "32", "--run-name", "mesh-unet"]),
        ("resnet18", train_classifier.main, ["--width", "64", "--batch-size", "256", "--run-name", "mesh-resnet18"]),
    ):
        k1.launches = 0
        t0 = time.perf_counter()
        _, calls = capture_k1(k1, lambda: main_fn(argv + common + cluster))
        torch.cuda.synchronize()
        errs = check_captured(k1, {"warp_twopass": calls["warp_twopass"][:1], "hat_resample": []}, f"cli {kind}")
        rec[kind] = {"wall_s": time.perf_counter() - t0, "k1_launches": k1.launches,
                     "k1_err": max(e for case in errs.values() for e in case.values()),
                     "backend": torch.distributed.get_backend(), "world": mesh_lib.process_count()}
    with open(os.path.join(out_dir, "cli.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def phase_parallel(k1, seed: int, root: str, res128, frames8) -> tuple[int, dict]:
    """Phase 13: the data-parallel layer on the one card.  (a) two ranks
    (gloo) against one process: a full-width train step of each trainer's
    model; (b) both trainers' command lines at world size 1 over NCCL;
    (c) ``Engine(mesh=…)`` at B=128 over two ranks against the one-process
    ``process_batch`` of phase 4.  Returns K1's launches (every process's)
    and the numbers."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.runstore import Run

    out_dir = tempfile.mkdtemp(prefix="mesh-", dir=root)
    t0 = time.perf_counter()
    port = free_port()
    run_children([["--mesh-child", str(r), "2", str(port), out_dir, str(seed)] for r in range(2)], timeout=900)
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    log(f"[parallel] two gloo ranks on {ranks[0]['device']} done in {time.perf_counter() - t0:.1f} s")
    one = parity_steps(k1, None, seed)
    launches = sum(r["steps"][k]["k1_launches"] for r in ranks for k in r["steps"])
    launches += sum(one[k]["k1_launches"] for k in one)
    worst = 0.0
    res = {"steps": {}}
    problems = []  # (a) and (c) are both read before the phase fails
    for name in one:
        a, b, o = ranks[0]["steps"][name], ranks[1]["steps"][name], one[name]
        for key in ("loss", "metric", "param_norm", "stats"):
            if a[key] != b[key]:
                problems.append(f"(a) {name}: {key} differs between the ranks")
        tol = MESH_TOL[name.split()[1]]
        errs = {key: rel(a[key], o[key]) for key in tol}
        worst = max(worst, a["k1_err"], b["k1_err"], o["k1_err"])
        res["steps"][name] = {"errors_vs_one_process": errs, "loss": a["loss"], "metric": a["metric"]}
        timing = ""
        if "step_ms" in a:
            res["steps"][name].update(mesh_step_ms=[a["step_ms"], b["step_ms"]], one_process_step_ms=o["step_ms"])
            timing = (f"; step {a['step_ms']:.2f} / {b['step_ms']:.2f} ms a rank against {o['step_ms']:.2f} ms in one "
                      f"process (two ranks share one card and stage every collective through host memory: no "
                      f"scaling is measured)")
        log(f"[parallel] (a) {name} step, 2 gloo ranks vs one process: relative errors {json.dumps(errs)} "
            f"(bounds {json.dumps(tol)}); equal across ranks{timing}")
        bad = {k: v for k, v in errs.items() if not v <= tol[k]}
        if bad:
            problems.append(f"(a) {name}: the two-rank step differs from the one-process step beyond the bounds: {bad}")

    t0 = time.perf_counter()
    run_children([["--cli-trainers", root, str(free_port()), out_dir, str(seed)]], timeout=900)
    cli = json.load(open(os.path.join(out_dir, "cli.json")))
    store = os.environ["CVTPU_STORE_ROOT"]
    for kind, project in (("unet", "chessvision-segmentation"), ("resnet18", "chessvision-classification")):
        run = Run(project, f"mesh-{kind}")
        losses = [s["train_loss"] for s in run.scalars() if "train_loss" in s]
        if cli[kind]["backend"] != "nccl" or cli[kind]["world"] != 1 or not (len(losses) == 1 and np.isfinite(losses).all()):
            fail(f"parallel (b) {kind}: {cli[kind]} losses {losses}")
        cli[kind]["train_losses"] = losses
        cli[kind]["checkpoint"] = str(run.bulk_data_url / "checkpoint.npz")
        launches += cli[kind]["k1_launches"]
        worst = max(worst, cli[kind]["k1_err"])
    cv = ChessVision(board_extractor_weights=cli["unet"]["checkpoint"],
                     classifier_weights=cli["resnet18"]["checkpoint"], device="cuda")
    k1.launches = 0
    served = cv.engine.process_batch(frames8)
    launches += k1.launches
    if not np.isfinite(served.probabilities).all():
        fail("parallel (b): the rank-0 checkpoints do not serve finite outputs")
    res["cli"] = cli
    log(f"[parallel] (b) the trainers' CLI at world size 1 over NCCL: {json.dumps(cli)} in "
        f"{time.perf_counter() - t0:.1f} s; the checkpoints serve through ChessVision (store {store})")

    engine_problems = []
    for r in ranks:
        quads = np.load(os.path.join(out_dir, f"quads{r['rank']}.npy"))
        same = (r["fens"] == list(res128.fens) and r["found"] == res128.board_found.tolist()
                and np.array_equal(quads, res128.quadrangle))
        if not same:
            n_fen = sum(a == b for a, b in zip(r["fens"], res128.fens))
            engine_problems.append(f"(c) rank {r['rank']}: Engine(mesh) differs from the one-process process_batch "
                            f"(FENs equal {n_fen}/128, found equal {r['found'] == res128.board_found.tolist()}, "
                            f"max quad diff {float(np.abs(quads - res128.quadrangle).max())})")
        launches += r["engine_k1_launches"]
        worst = max(worst, r["engine_k1_err"])
    res["engine_ms"] = [r["engine_ms"] for r in ranks]
    log(f"[parallel] (c) Engine(mesh=2 gloo ranks).process_batch B=128 ({ranks[0]['engine_rows']} rows a rank): "
        f"FENs, found and quads {'differ' if engine_problems else 'equal the one-process B=128 result on both ranks'}; "
        f"{res['engine_ms'][0]:.1f} / {res['engine_ms'][1]:.1f} ms a call (gather through host memory); "
        f"K1 launches {[r['engine_k1_launches'] for r in ranks]}")
    problems += engine_problems
    if not worst <= K1_TOL:
        problems.append(f"K1 differs from its plain version by {worst}")
    if problems:
        fail("parallel: " + "; ".join(problems))
    res["k1_max_abs_err"] = worst
    return launches, res


def phase_data(k1, seed: int, root: str, frames128) -> tuple[int, dict]:
    """Phase 14: the data tools.  64 seeded 512² JPEG frames in a folder;
    the native loader built from ``native/cvloader`` (a failed build fails
    the phase where the machine has libjpeg/libpng headers): ``load_batch``
    against cv2, the packers bit-identical to numpy and their host ms at
    B=128; ``run_pipeline(input_folder=…)`` with the committed weights
    against a table recomputed from ``process_batch`` on the same decoded
    frames; ``scan_image_issues`` over the folder.  Returns K1's launches."""
    import cv2
    import numpy as np
    import torch

    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch import ingest, native_loader
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.curation import scan_image_issues
    from chessvision_tpu_torch.synthetic import board_frames

    folder = os.path.join(root, "uploads")
    os.makedirs(folder)
    frames = board_frames(seed + 7, 64)[0]
    paths = []
    for i, f in enumerate(frames):
        paths.append(os.path.join(folder, f"up{i:03d}.jpg"))
        cv2.imwrite(paths[-1], f)
    t0 = time.perf_counter()
    built, why = native_loader.build_status()
    headers = native_loader.headers_present()
    log(f"[data] native loader: {'built' if built else 'NOT built'} in {time.perf_counter() - t0:.1f} s ({why}); "
        f"libjpeg/libpng headers present: {headers}; decode path: {'native cvloader' if built else 'cv2'}")
    if headers and not built:
        fail(f"data: the machine has the headers but the native loader did not build: {why}")
    res: dict = {"native_built": built, "why": why, "headers": headers}
    if built:
        batch, failures = native_loader.load_batch(paths, 512, 512, 3)
        want = np.stack([cv2.imread(p_) for p_ in paths])
        diff = np.abs(batch.astype(int) - want.astype(int))
        res["load_batch_vs_cv2"] = {"mean_abs": float(diff.mean()), "share_over_8": float((diff > 8).mean()),
                                    "max": int(diff.max())}
        log(f"[data] load_batch 64 JPEGs vs cv2.imread (no resize at 512²): {json.dumps(res['load_batch_vs_cv2'])}")
        if failures or not (diff.mean() < 2.0 and (diff > 8).mean() < 0.01):
            fail(f"data: load_batch differs from cv2 ({failures} failures, {res['load_batch_vs_cv2']})")
        small, _ = native_loader.load_batch(paths[:8], 256, 256, 3)
        want_small = np.stack([cv2.resize(cv2.imread(p_), (256, 256), interpolation=cv2.INTER_AREA) for p_ in paths[:8]])
        d2 = np.abs(small.astype(int) - want_small.astype(int))
        if not (d2.mean() < 2.0 and (d2 > 8).mean() < 0.01):
            fail(f"data: load_batch at 256² differs from cv2 + INTER_AREA: mean {d2.mean()}")
        comp, gray = engine_mod.pack_inputs(frames128)
        for name, native, plain in (("yuv444", native_loader.pack_yuv444, engine_mod._pack_yuv444_numpy),
                                    ("yuv420", native_loader.pack_yuv420, engine_mod._pack_yuv420_numpy)):
            got, ref = native(comp, gray), plain(comp, gray)
            if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                fail(f"data: native pack_{name} is not bit-identical to numpy")
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                native(comp, gray)
            t_native = (time.perf_counter() - t0) * 1e3 / reps
            t0 = time.perf_counter()
            for _ in range(reps):
                plain(comp, gray)
            t_plain = (time.perf_counter() - t0) * 1e3 / reps
            res[f"pack_{name}_ms"] = {"native": t_native, "numpy": t_plain}
            log(f"[data] pack_{name} B=128 (after pack_inputs): native {t_native:.2f} ms, numpy {t_plain:.2f} ms "
                f"a batch on the host; bit-identical")
        t0 = time.perf_counter()
        engine_mod.pack_inputs(frames128)
        res["pack_inputs_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"[data] pack_inputs B=128 (cv2 INTER_AREA + gray, shared by both packers) {res['pack_inputs_ms']:.2f} ms")

    cv = ChessVision(device="cuda")
    cv.engine.process_batch(frames[:32])  # warm-up at the pipeline's batch
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    (table, run), calls = capture_k1(k1, lambda: ingest.run_pipeline(input_folder=folder, cv_model=cv, table_name="smoke"))
    wall = time.perf_counter() - t0
    launches = k1.launches
    errs = check_captured(k1, {"warp_twopass": calls["warp_twopass"][:1], "hat_resample": []}, "ingest")
    res["images_per_s"] = len(paths) / wall
    res["k1_max_abs_err"] = max(e for case in errs.values() for e in case.values())
    got = run.read_metrics_table("enrichment")
    if launches != 4 or len(table) != 64 or len(got["fen"]) != 64:
        fail(f"data: run_pipeline ran {launches} K1 launches over {len(got['fen'])} of {len(table)} rows")
    decoded = native_loader.load_batch(paths, 512, 512)[0] if built else np.stack([cv2.imread(p_) for p_ in paths])
    want = {k: [] for k in ("extraction_success", "fen", "probability_distribution", "mask_completeness",
                            "quadrangle_regularity", "probability_confidence")}
    for start in range(0, 64, 32):
        r = cv.engine.process_batch(decoded[start : start + 32], 0.5)
        probs = 1.0 / (1.0 + np.exp(-r.logits))
        for bi in range(len(r.fens)):
            found = bool(r.board_found[bi])
            want["extraction_success"].append(int(found))
            want["fen"].append(r.fens[bi] if found else "")
            want["probability_distribution"].append(ingest.probability_distribution(probs[bi]))
            want["mask_completeness"].append(ingest.mask_completeness(probs[bi]))
            want["quadrangle_regularity"].append(ingest.quadrangle_regularity(r.quadrangle[bi] if found else None))
            want["probability_confidence"].append(ingest.probability_confidence(probs[bi]))
    if list(got["fen"]) != want["fen"] or list(got["extraction_success"]) != want["extraction_success"]:
        fail("data: run_pipeline's FENs or success flags differ from process_batch's on the same frames")
    score_err = max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))))
                    for k in want if k not in ("fen", "extraction_success"))
    if not score_err <= 1e-6:
        fail(f"data: run_pipeline's quality scores differ from the recomputed ones by {score_err}")
    res["score_max_abs_err"] = score_err
    log(f"[data] run_pipeline 64 frames: {res['images_per_s']:.1f} images/s end to end (decode, engine, scores, "
        f"table), found {int(np.sum(got['extraction_success']))}/64; FENs and flags equal process_batch's, scores "
        f"within {score_err:.2g}; K1 launches {launches}, max |kernel - plain| {res['k1_max_abs_err']}")
    issues = scan_image_issues(paths)
    res["issues"] = {k: int(np.sum(v)) for k, v in issues.items() if k.startswith("is_") or k == "readable"}
    log(f"[data] scan_image_issues over the folder: {json.dumps(res['issues'])}")
    if res["issues"]["readable"] != 64:
        fail("data: scan_image_issues could not read every frame")
    return launches, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="also print stage times, device busy share and peak memory")
    ap.add_argument("--load-client", nargs=2, metavar=("PORT", "BODIES"), help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", nargs=5, metavar=("RANK", "WORLD", "PORT", "OUT", "SEED"), help=argparse.SUPPRESS)
    ap.add_argument("--cli-trainers", nargs=4, metavar=("ROOT", "PORT", "OUT", "SEED"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.load_client:  # the server phase's own child process
        return load_client(int(args.load_client[0]), args.load_client[1])
    if args.mesh_child:  # one rank of the parallel phase
        r, w, port, out, seed = args.mesh_child
        return mesh_child(int(r), int(w), int(port), out, int(seed))
    if args.cli_trainers:  # the parallel phase's world-size-1 trainers
        root, port, out, seed = args.cli_trainers
        return cli_trainers_child(root, int(port), out, int(seed))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from chessvision_tpu_torch import constants, cuda_build, profiling
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.ops.warp import get_perspective_transform, invert_homography
    from chessvision_tpu_torch.synthetic import board_frames, limit_chroma

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
    t128 = profiling.wall_ms(engine.process_batch, frames128, iters=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x128 = torch.from_numpy(frames128).cuda()
    dev128 = profiling.wall_ms(engine.run_device, x128, iters=5)
    one = frames8[:1]
    lat_full, lat_lite = [], []
    for _ in range(40):  # interleaved, so drift hits both alike
        lat_full += profiling.wall_ms(engine.process_batch, one, iters=1)
        lat_lite += profiling.wall_ms(lambda: engine.process_batch(one, lite=True), iters=1)
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
            stages, total = profiling.stage_breakdown(engine, frames, iters=3)
            log(f"[stages] {name} process_batch {total:.2f} ms (stages synchronized): "
                + json.dumps({k: round(v, 3) for k, v in stages.items()}))
            busy, wall, table = profiling.device_busy(lambda: engine.process_batch(frames))
            log(f"[profile] {name} process_batch: device busy {busy:.2f} ms of {wall:.2f} ms wall "
                f"({100 * busy / wall:.1f}%), top ops by device time\n{table}")

    # -- 6–9. the serving path -------------------------------------------------------------------
    phase_codecs(engine, engine_mod, constants, frames8, limit_chroma(frames8))
    launches_stream, errs_stream = phase_stream(engine, engine_mod, k1, frames128, args.profile)
    launches_yolo, errs_yolo = phase_yolo(k1, frames8)
    launches_server, errs_server = phase_server(k1, frames8)
    errs_serving = {**errs_stream, **errs_yolo, **errs_server}
    log(f"[k1] max |kernel - plain| on the serving paths' inputs: {json.dumps(errs_serving)}")
    worst = max(worst, *(e for case in errs_serving.values() for e in case.values()))

    # -- 10–12. augmentation, training, evaluation --------------------------------------------
    launches_augment, errs_augment, k1_augment = phase_augment(k1, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        launches_train, train_results = phase_train(k1, args.seed, root, frames8, args.profile)
        launches_eval = phase_eval(k1, args.seed, root)
        # -- 13–14. data parallelism, the data tools --------------------------------------------------
        launches_parallel, parallel = phase_parallel(k1, args.seed, root, res128, frames8)
        launches_data, data_res = phase_data(k1, args.seed, root, frames128)
    worst = max(worst, parallel["k1_max_abs_err"], data_res["k1_max_abs_err"])
    log(f"[parallel] summary {json.dumps({k: v for k, v in parallel.items() if k != 'cli'})}")
    log(f"[data] summary {json.dumps(data_res)}")
    log(f"[k1] max |kernel - plain| on the augmentation inputs: {json.dumps(errs_augment)}")
    worst = max(worst, *(e for case in errs_augment.values() for e in case.values()))
    log(f"[main] K1 launches by path: process_image + process_batch {launches}, run_stream {launches_stream}, "
        f"yolo {launches_yolo}, server {launches_server}, augment {launches_augment}, train {launches_train}, "
        f"eval {launches_eval}, parallel {launches_parallel} (every rank's), data {launches_data}")
    log(f"[train] summary {json.dumps({k: v['timing'] for k, v in train_results.items()})}")

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
        "launches": (launches + launches_stream + launches_yolo + launches_server + launches_augment
                     + launches_train + launches_eval + launches_parallel + launches_data),
        "max_abs_err": worst,
        "ms": k1_128["ms"],
        "plain_ms": k1_128["plain_ms"],
        "bound_ms": k1_128["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1_128["library_ms"],
        "augment_shapes": {name: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "two_kernel_floor_ms")}
                           for name, t in k1_augment.items()},
    }]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
