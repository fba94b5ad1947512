"""Drive the PyTorch port of chessvision on NVIDIA GPUs and check it.

    python3 chip_smoke.py [--seed N] [--profile] [--cards N] [--only multicard|graft]

Phases 1–15 and 17–22 need one card; phase 16 and phase 22 (c) run over
every card of a machine that shows two or more, or over ``--cards N``
(which fails with fewer); ``--only multicard`` (``--only graft``) builds
the kernels and runs phase 16 (22) alone.
(``--load-client``, ``--mesh-child``, ``--cli-trainers``,
``--multicard-child`` and ``--edges-child`` are the script's own child
processes.)

Phases (any failure exits non-zero without the final result line):

1. build: compile every CUDA kernel of the port from ``chessvision_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. main path: ``ChessVision.process_image`` and ``Engine.process_batch``
   (refine="arbitrate", margin 32) with the committed UNet(base=32) and
   ResNet18 weights in bfloat16 on synthetic 512² frames made from
   ``--seed``; each kernel's launch count is zeroed just before and read
   just after, and must have risen (K1 2 a pipeline call at 512², pass 1
   and pass 2, ``bn_act`` once a BatchNorm layer of the UNet and twice of
   the ResNet18);
3. plain path: the same batch with each kernel (K1's entries and
   ``bn_act``) swapped for its plain PyTorch version must give the same
   ``found`` flags, FENs and boards;
4. kernels vs plain: ``bn_act`` against its plain version bit for bit at
   every call shape the bfloat16 and the float32 models hand it at batch 8
   and on seeded edge cases (NaN and ±Inf, 13 channels on a 37×41 map, a
   transposed view, a channels-last map, an unaligned view; each in and out
   of bf16 and float32, with and without residual and ReLU), timed at the
   UNet's first layer and a ResNet18 block at batch 128 beside its bound,
   its plain version and the eager ops it replaced; both entries of K1
   against their plain versions
   (stated tolerance): ``warp_twopass`` and each kernel of both its routes
   (``warp_pass1``, ``warp_pass2``, ``warp_fused``) on the inputs the main
   path gave it at batch 8 and 128 and on seeded rotated, out-of-frame and
   identity quads, ``hat_resample`` on the positions of the same inputs
   and on border and upscale cases; then the times at batch 128 of the
   warp, of both routes (warm and with the L2 cache flushed), of each
   pass, of the route with the positions in memory, of the plain version
   and of a PyTorch yardstick, beside the least time the card could take
   (bound);
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
   ``curation.scan_image_issues``;
15. launchers: the three ``examples/torch_*.py`` ``main()`` in this process
   (FENs and found flags equal ``process_batch``'s on the same frames; the
   streaming example's boards/s), the raw stream of a one-process
   ``Engine(mesh=create_mesh())`` against the mesh-free stream, ``bash -n``
   on every ``scripts/bin/torch_*.sh``, ``torch_evaluate.sh`` on phase 12's
   test root and ``torch_serve.sh --local`` answering one post;
16. multicard (``parallel/mesh.py`` over NCCL, one process per card,
   ``cuda:0``…``cuda:N-1``): (a) at two seeds, each trainer's full-width
   step over N ranks against one process on the same global batch
   (``MESH_TOL`` raised to what the precision moves one process from a
   float64 witness, and a control without collectives outside it),
   equal across ranks, every rank's augmented rows equal to the
   one-process augmentation's rows bit for bit; (b) step ms a rank and
   images/s over the ranks, strong (UNet B=32, ResNet18 B=256 split over
   N) and weak (that batch on every rank), beside one process on one card;
   (c) ``NPROC=N scripts/bin/torch_train_distributed.sh --epochs 1`` and
   ``torchrun --nproc-per-node N -m chessvision_tpu_torch.train.train_classifier
   --epochs 1`` through torchrun's environment, every process exiting 0,
   rank 0's checkpoints served by ``ChessVision``; (d) ``Engine(mesh=…)``
   at B=128 and its raw stream against the one-process result; (e) K1 on
   every card against its plain version, timed at the per-rank
   augmentation shapes; (f) each rank holds a context and memory on its
   own card only (libcuda's record of each process, and nvidia-smi while
   the ranks are alive);
17. photos: the main path on camera-size frames (``synthetic.photo_frames``:
   12 MP landscape and portrait, 48 MP, and 3023×4031 for pass 1's scalar
   branch; bfloat16, refine="arbitrate"): a 12 MP and a 48 MP JPEG posted
   to the server twice each (the first pays its shapes' first call), then
   ``comp`` and ``gray`` on the card against the CPU bit for bit,
   ``process_image`` at each size against ``process_batch`` of its frame,
   ``process_batch`` at B=4 of 12 MP (full and lite) and B=2 of 48 MP; the
   K1 launches of the route ``warp_plan`` names a pipeline call (the fused
   kernel at these sizes), each call held against the plain version,
   ``found``, FENs and boards against the plain-K1 path (phase 3's rule),
   served FENs against ``process_batch``'s on the decoded frames; then
   ``process_image`` p50 at 12 and 48 MP, ``process_batch`` B=4 at 12 MP,
   the upload, the stages of a B=1 call, and K1 at each size: the fused
   route against the two-pass route (warm and cold), ``F.grid_sample``
   twice and the function's floor, per pass beside its bounds;
18. edges: an empty batch through ``process_batch`` (full and lite),
   ``run_device`` and the raw ``run_stream`` gives the JAX package's
   fields, shapes and dtypes with no K1 launch; three child processes with
   ``CVTPU_REFINE=detect``, ``CVTPU_REFINE_MARGIN=0`` (a 512² canvas) and
   ``CVTPU_ROOT`` at a copy of ``weights/`` give the FENs of this process's
   explicit ``refine_grid="detect"``, margin 0 and checkout weights;
19. measure: the port's measuring tools (``chessvision_tpu_torch/tools``),
   each one's ``main()`` in this process at its defaults: ``bench_torch.py``,
   ``profile_stages``, ``bench_training``, ``sweep_arbitrate_chunk`` at chunks
   128 and 512 (its default B=1024), ``microbench --which all`` (with K1's
   route sweep, both routes at B=1 heights 512–6048 and at B=128 512²) and ``mfu_accounting`` (on
   the times those printed); each prints its JSON line(s) with its keys
   and the card's name and power limit, the bench's last FENs equal
   ``process_batch``'s, the sweep's are equal across chunks, and K1 runs
   inside the bench, the stages, the trainers and the microbenchmark;
20. memory and the last entry points, after phase 19's bench streams in
   this process: ``run_device`` at B=1024 (the JAX package's batch) with
   ``found`` flags and FENs equal to two B=512 calls, the peak memory of
   each through the UNet and after the tail (and of B=128); phase 19's
   sweep at B=1024 without an error; ``tools/loadtest_server`` at 32
   requests one and 16 at a time (served FENs equal ``process_batch``'s);
   ``tools/make_hard_example_weights`` on a seeded squares root, then one
   ``train_classifier`` epoch with ``use_sample_weights`` reading the
   column it wrote.
21. test-set tools, on a seeded test root (``synthetic.write_test_root``: 16
   frames at 512², 2 at 768²): ``tools/make_fen_goldens`` on the CPU;
   ``tools/drift_gate`` on the card against those goldens (found flags
   identical, the FENs within the band ``GATE_*`` measured on an H100), and
   against two altered copies, each refused with the script's failure
   string; ``tools/debug_gridfix`` per image and ``--summary`` on the card
   and on the CPU (the boards whose chosen side or candidate FENs differ,
   the largest correction and gap differences, each device's shipping
   blend against its own ``process_batch`` FEN); ``tools/exp_gridfix_quad``
   on the card (its totals line); every K1 call of the phase held against
   its plain version, and K1 at 512²→512² timed beside its bound and
   ``F.grid_sample`` twice;
22. graft entry (``graft_entry_torch.py``): ``entry()`` on the card at its
   default B=8 (the registry's base-64 UNet and ResNet18, bfloat16, seeded
   random weights): its outputs' keys, shapes and dtypes (``ENTRY_LAYOUT``,
   the layout the CPU test holds against the JAX ``entry()``), K1's and
   ``bn_act``'s launches of one call (2 and 58), every K1 and ``bn_act``
   call held against its plain version, the warm ms of a call and both
   kernels timed at its shapes; ``dryrun_multichip(1)`` in this process
   (the segmentation and classification steps and ``Engine(mesh=…)`` with
   the YOLO pair, its printed line, its K1 calls against the plain
   version); with two or more cards, ``dryrun_multichip(N)`` over NCCL,
   one process a card, each holding a context on its own card only; two
   threads calling ``process_batch`` on 12 MP frames with the caller's
   TF32 on, every call's ``comp`` equal to one thread's in full float32
   and the flags back on after.

``bn_act``'s launches are counted over each path (zeroed just before,
read just after) and must have risen on every path that runs the UNet
or the ResNet18 in this process.  Phases 7–10, 13–19, 21 and 22 also record what
their path hands K1 (a streamed batch of each
kind, the YOLO call, every batch the server's burst ran: batch 1 up to 16)
and hold the kernel against its plain version on those inputs; the
server's launches must be 2 for each batch the micro-batcher ran.

``--profile`` adds stage times (device stages and the host steps of
``process_batch``), the device's busy share, peak memory, how much of
``run_stream``'s upload time lies under kernels, and the device's busy
share and top ops over 3 train steps of each trainer.

Output: a ``{"kernels": [...]}`` line (K1's three kernels: ``warp_pass1``
and ``warp_pass2`` timed on the main path and counted on it and on phase
22's, ``warp_fused`` on phase 17's photos; and ``bn_act``), the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Needs no network.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
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


def percentile(xs: list[float], q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def capture_k1(k1, fn, seen: set | None = None):
    """Run ``fn`` with both K1 entries recording the arguments they are
    given; with ``seen``, only a call whose entry and shapes are not in it
    yet (it grows by each call recorded)."""
    calls = {"warp_twopass": [], "hat_resample": []}
    saved = {name: getattr(k1, name) for name in calls}

    def recording(name):
        def run(*args):
            key = (name, *(tuple(a.shape) if hasattr(a, "shape") else a for a in args))
            if seen is None or key not in seen:
                calls[name].append(args)
                if seen is not None:
                    seen.add(key)
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
    """Run ``fn`` with every kernel swapped for its plain PyTorch version:
    both K1 entries, and ``bn_act`` where the models call it."""
    from chessvision_tpu_torch.models import layers
    from chessvision_tpu_torch.ops import bn_act as bnk

    saved = (k1.warp_twopass, k1.hat_resample, layers.bn_act)
    k1.warp_twopass, k1.hat_resample, layers.bn_act = k1.warp_twopass_plain, k1.hat_resample_plain, bnk.bn_act_plain
    try:
        return fn()
    finally:
        k1.warp_twopass, k1.hat_resample, layers.bn_act = saved


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def check_k1(k1, imgs, minv, out_h: int, out_w: int) -> dict:
    """max |kernel − plain| of both entries on one warp's inputs:
    ``warp_twopass`` whole (the route ``warp_plan`` picks), each kernel of
    both routes (``warp_fused``; ``warp_pass1`` against the plain
    intermediate and ``warp_pass2`` on it), and ``hat_resample`` on each
    pass's source and positions (pass 2's source is the transposed view,
    read in place)."""
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
        "warp_fused": max_err(k1.warp_fused(imgs, minv, out_h, out_w), want),
        "warp_pass1": max_err(k1.warp_pass1(imgs, minv, out_w), tmp),
        "warp_pass2": max_err(k1.warp_pass2(tmp, minv, out_h), want),
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


def capture_bn(fn):
    """Run ``fn`` with the models' ``bn_act`` recording the first call of
    each (shape, dtype, residual, ReLU, output dtype) it is given: returns
    (fn's result, the recorded argument tuples)."""
    import torch

    from chessvision_tpu_torch.models import layers

    real = layers.bn_act
    calls: dict = {}

    def recording(x, mean, mul, bias, residual=None, relu=False, out_dtype=torch.float32):
        key = (tuple(x.shape), x.dtype, residual is not None, relu, out_dtype)
        calls.setdefault(key, (x, mean, mul, bias, residual, relu, out_dtype))
        return real(x, mean, mul, bias, residual, relu, out_dtype)

    layers.bn_act = recording
    try:
        result = fn()
    finally:
        layers.bn_act = real
    return result, list(calls.values())


def bn_bits(t):
    """A tensor's bits in NCHW order (NaN payloads included)."""
    import torch

    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_bn(bnk, args: tuple) -> float:
    """``bn_act`` against ``bn_act_plain`` on one call's arguments: fails
    unless every bit of the result is equal; returns max |kernel − plain|
    (0.0 when equal)."""
    import torch

    got, want = bnk.bn_act(*args), bnk.bn_act_plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(bn_bits(got), bn_bits(want)):
        diff = (got.float() - want.float()).abs().nan_to_num(nan=float("inf")).max()
        x = args[0]
        fail(f"bn_act differs from its plain version on {tuple(x.shape)} {x.dtype} stride {x.stride()} "
             f"(residual {args[4] is not None}, relu {args[5]}, out {args[6]}): max |diff| {float(diff)}")
    return 0.0


def bn_edge_cases(seed: int) -> dict:
    """Seeded inputs the models do not give ``bn_act``: NaN and ±Inf, 13
    channels and a 37×41 map (a ragged last group of 8), a transposed view
    with a transposed residual, a channels-last map beside an NCHW
    residual, and a view 4 bytes off its storage's start (not 16-byte
    aligned); each in bf16 and float32, with and without residual and
    ReLU, into bf16 and float32.  Returns {name: [argument tuples]}."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return (3 * torch.randn(shape, generator=g)).cuda()

    special = randn(4, 16, 32, 32)
    flat = special.view(-1)
    flat[::97], flat[5::101], flat[7::103] = float("nan"), float("inf"), -float("inf")
    maps = {
        "nan/inf": (special, randn(4, 16, 32, 32)),
        "13 channels 37x41": (randn(3, 13, 37, 41), randn(3, 13, 37, 41)),
        "transposed": (randn(2, 24, 40, 48).transpose(2, 3), randn(2, 24, 40, 48).transpose(2, 3)),
        "channels_last": (randn(4, 24, 16, 16).to(memory_format=torch.channels_last), randn(4, 24, 16, 16)),
        "unaligned": (randn(1 + 2 * 8 * 8 * 8), randn(2, 8, 8, 8)),
    }
    cases: dict = {}
    for name, (x, res) in maps.items():
        c = res.shape[1]
        mean, bias = randn(c), randn(c)
        mul = torch.rsqrt(torch.rand(c, generator=g).cuda() + 0.2 + 1e-5) * (torch.rand(c, generator=g).cuda() + 0.5)
        cases[name] = []
        for dt in (torch.bfloat16, torch.float32):
            # .to keeps a dense view's strides; the unaligned map is cut after the cast
            xd = x.to(dt)[1:].view(res.shape) if name == "unaligned" else x.to(dt)
            cases[name] += [(xd, mean, mul, bias, r, relu, out) for r in (None, res) for relu in (False, True)
                            for out in (torch.bfloat16, torch.float32)]
    return cases


def time_bn(bnk, args: tuple, bn) -> dict:
    """Times (ms, CUDA events) of ``bn_act`` on one call's arguments beside
    its plain version, the PyTorch yardstick (``F.batch_norm`` in float32 on
    the running statistics of ``bn``, ``F.relu``, then the cast: the eager
    path the kernel replaced) and its bound: each element read once (and
    the residual), each output written once, the three channel arrays, at
    the data sheet's memory rate."""
    import torch
    import torch.nn.functional as F

    from chessvision_tpu_torch.tools.microbench import event_ms

    x, mean, mul, bias, residual, relu, out_dtype = args

    def library():
        y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        if residual is not None:
            y = y + residual
        return (F.relu(y) if relu else y).to(out_dtype)

    n = x.numel()
    io_bytes = n * x.element_size() + n * torch.empty((), dtype=out_dtype).element_size() + 3 * 4 * x.shape[1]
    if residual is not None:
        io_bytes += 4 * residual.numel()
    with torch.inference_mode():
        res = {
            "shape": list(x.shape), "in": str(x.dtype), "out": str(out_dtype), "residual": residual is not None,
            "relu": relu, "ms": event_ms(lambda: bnk.bn_act(*args), iters=20),
            "plain_ms": event_ms(lambda: bnk.bn_act_plain(*args), iters=5),
            "library_ms": event_ms(library, iters=5), "bytes": io_bytes,
            "bound_ms": io_bytes / HBM_BYTES_PER_S * 1e3,
        }
    return res


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
    """Times (ms) on one warp's inputs: ``tools/microbench.warp_times`` (the
    kernels, the plain version, the grid_sample yardstick given the
    positions, and the function's floor ``bound_ms``: the source sectors its
    taps touch, the matrices read and the boards written), then each kernel
    alone, the route with the positions in memory (positions built by torch
    ops, then ``hat_resample`` for each pass) and the yardstick with
    building the positions.  The designs' bounds, at the data sheet's
    memory rate: the whole images read, as pass 1 stages them, and the
    intermediate written and read as well; ``copy_tb_per_s`` is what a
    device-to-device copy of the images reaches (bytes read + written over
    its time).  Both routes (``microbench.route_times``: ``fused_ms``,
    ``twopass_ms``, warm and cold, and ``route``, the one ``warp_plan``
    picks) and the yardstick cold (``library_cold_ms``: each call alone
    after an L2 flush, its device time), and each kernel as a function of
    its own: the fused kernel's plain version (``warp_fused_plain``), and
    for each pass its plain version with its positions, one
    ``grid_sample`` given them, and its floor (the 32-byte sectors its
    taps read, ``flops.row_tap_sector_bytes``, and what it writes)."""
    import torch

    from chessvision_tpu_torch.tools.flops import row_tap_sector_bytes
    from chessvision_tpu_torch.tools.microbench import cold_ms, event_ms, grid_sample_rows, route_times, warp_times

    src_h = imgs.shape[1]
    res = {"shape": [list(imgs.shape), out_h, out_w], **warp_times(imgs, minv, out_h, out_w, plain_iters, HBM_BYTES_PER_S)}
    tmp = k1.warp_pass1(imgs, minv, out_w)
    res["pass1_ms"] = event_ms(lambda: k1.warp_pass1(imgs, minv, out_w), iters=20)
    res["pass2_ms"] = event_ms(lambda: k1.warp_pass2(tmp, minv, out_h), iters=20)

    def positions_route():
        hx, vy = k1.twopass_positions(minv, src_h, out_h, out_w)
        mid = k1.hat_resample(imgs, hx)
        return k1.hat_resample(mid.transpose(1, 2), vy).transpose(1, 2)

    hx, vy = k1.twopass_positions(minv, src_h, out_h, out_w)
    tmp_t = tmp.transpose(1, 2)
    res["positions_route_ms"] = event_ms(positions_route, iters=10)
    res["positions_ms"] = event_ms(lambda: k1.twopass_positions(minv, src_h, out_h, out_w), iters=10)
    res["hat_resample_pass1_ms"] = event_ms(lambda: k1.hat_resample(imgs, hx), iters=20)
    res["hat_resample_pass2_ms"] = event_ms(lambda: k1.hat_resample(tmp_t, vy), iters=20)

    def library_with_positions():
        hx_, vy_ = k1.twopass_positions(minv, src_h, out_h, out_w)
        mid = grid_sample_rows(imgs, hx_)().reshape(imgs.shape[0], src_h, out_w)
        return grid_sample_rows(mid.transpose(1, 2), vy_)()

    res["library_with_positions_ms"] = event_ms(library_with_positions, iters=5)
    res.update(route_times(imgs, minv, out_h, out_w, iters=20))
    res["library_cold_ms"] = cold_ms(grid_sample_rows(imgs, hx), 20) + cold_ms(grid_sample_rows(tmp_t, vy), 20)
    res["fused_plain_ms"] = event_ms(lambda: k1.warp_fused_plain(imgs, minv, out_h, out_w), plain_iters, 1)
    res["pass1_plain_ms"] = event_ms(
        lambda: k1.hat_resample_plain(imgs, k1.twopass_positions(minv, src_h, out_h, out_w)[0]), plain_iters, 1)
    res["pass2_plain_ms"] = event_ms(
        lambda: k1.hat_resample_plain(tmp_t, k1.twopass_positions(minv, src_h, out_h, out_w)[1]), plain_iters, 1)
    res["pass1_library_ms"] = event_ms(grid_sample_rows(imgs, hx), iters=20)
    res["pass2_library_ms"] = event_ms(grid_sample_rows(tmp_t, vy), iters=20)
    res["pass1_floor_ms"] = (row_tap_sector_bytes(imgs, hx) + 4 * (tmp.numel() + minv.numel())) / HBM_BYTES_PER_S * 1e3
    res["pass2_floor_ms"] = (row_tap_sector_bytes(tmp_t, vy) + 4 * (imgs.shape[0] * out_h * out_w + minv.numel())
                             ) / HBM_BYTES_PER_S * 1e3
    scratch = torch.empty_like(imgs)
    res["copy_tb_per_s"] = 8 * imgs.numel() / event_ms(lambda: scratch.copy_(imgs), iters=20) / 1e9
    io_bytes = 4 * (minv.numel() + imgs.shape[0] * out_h * out_w)
    res["source_share"] = res["tap_bytes"] / (4 * imgs.numel())
    design_bytes = 4 * imgs.numel() + io_bytes
    res["two_kernel_floor_ms"] = (design_bytes + 8 * tmp.numel()) / HBM_BYTES_PER_S * 1e3
    res["positions_route_floor_ms"] = (
        design_bytes + 4 * (2 * tmp.numel() + hx.numel() + vy.numel())
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


def seg_batch(seed: int, b: int, size: int = 256, host: bool = False):
    """(b, size, size, 3) float32 synthetic frames in [0, 1] and their
    (b, size, size) board masks, on the card (numpy with ``host``)."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.synthetic import board_frame, quad_mask

    rng = np.random.default_rng(seed)
    pairs = [board_frame(rng, size) for _ in range(b)]
    imgs = np.stack([p[0] for p in pairs]).astype(np.float32) / 255.0
    masks = np.stack([quad_mask(p[1], size) for p in pairs]).astype(np.float32) / 255.0
    if host:
        return imgs, masks
    return torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()


def cls_batch(seed: int, b: int, host: bool = False):
    """(b, 64, 64, 1) float32 synthetic squares in [0, 1] and their labels,
    on the card (numpy with ``host``)."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.synthetic import SQUARE_CLASS_DIRS, square_crop

    rng = np.random.default_rng(seed)
    labels = np.arange(b) % len(SQUARE_CLASS_DIRS)
    crops = np.stack([square_crop(rng, SQUARE_CLASS_DIRS[c]) for c in labels]).astype(np.float32) / 255.0
    if host:
        return crops[..., None], labels
    return torch.from_numpy(crops[..., None]).cuda(), torch.from_numpy(labels).cuda()


def rows_on_card(mesh, host_arrays, n: int):
    """This rank's rows of the global host batches (each tiled ``n`` times
    along the batch), on its card, and those rows' (start, stop) in the
    global batch (None in one process, which takes them all)."""
    import numpy as np
    import torch

    from chessvision_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh.device if mesh is not None else torch.device("cuda")
    tiled = [np.concatenate([a] * n) if n > 1 else a for a in host_arrays]
    rows = None if mesh is None else mesh_lib.process_local_batch_slice(len(tiled[0]), mesh)
    return [mesh_lib.make_global_batch(mesh, a).to(dev) for a in tiled], rows, len(tiled[0])


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


def same_keys_and_shapes(path: str, reference: str) -> list[str]:
    """Keys whose presence or shape differ between two checkpoints, apart
    from the optimizer leaves and the metadata."""
    import numpy as np

    def shapes(p):
        with np.load(p) as d:
            return {k: d[k].shape for k in d.files if not (k.startswith("opt_state/") or k == "__metadata__")}

    a, b = shapes(path), shapes(reference)
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def time_train_steps(k1, kind: str, seed: int, profile: bool = False, mesh=None, per_rank: bool = False) -> dict:
    """20 train steps at the trainers' configuration on device-resident
    batches, augmentation included and one host sync a step (the loss), as
    the trainers run: step ms, images/s and K1 launches a step; with
    ``profile``, the device's busy share over 3 more steps and the top ops.
    On a ``mesh`` each rank uploads and augments its rows of the global
    batch (the shipping batch, or with ``per_rank`` the shipping batch on
    every rank) and steps on them; images/s counts every rank's."""
    import torch

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.train import steps
    from chessvision_tpu_torch.tools.flops import conv_flops
    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch, fold_in

    n = mesh.size if mesh is not None and per_rank else 1
    torch.manual_seed(seed)
    if kind == "unet":
        model = models.UNet(base=32)
        (imgs, targets), rows, b = rows_on_card(mesh, seg_batch(seed, 32, host=True), n)
        tx = steps.Chain([steps.ClipByGlobalNorm(1.0), steps.AddDecayedWeights(1e-8),
                          steps.inject_hyperparams(steps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
        train_step = steps.make_seg_train_step(mesh)

        def batch(i):
            return augment_segmentation_batch(fold_in(seed, i), imgs, targets, rows=rows, global_batch=b)
    else:
        model = models.resnet18(width=64)
        (imgs, targets), rows, b = rows_on_card(mesh, cls_batch(seed, 256, host=True), n)
        tx = steps.adam(steps.exponential_decay(1e-3, 16, 0.1, staircase=True))
        train_step = steps.make_cls_train_step(mesh)

        def batch(i):
            return augment_classification_batch(fold_in(seed, i), imgs, rows=rows, global_batch=b), targets

    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = mesh_lib.replicate(mesh, set_compute_dtype(model, torch.bfloat16, master_weights=True).to(dev))
    state = steps.TrainState.create(model, tx)
    for i in range(3):  # warm-up: cuDNN algorithm choice
        train_step(state, *batch(i))["loss"].item()
    torch.cuda.synchronize(dev)
    iters = 20
    k1.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(iters):
        losses.append(train_step(state, *batch(3 + i))["loss"].item())
    torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    launches = k1.launches
    flops_fwd = conv_flops(model, imgs[:1]) * imgs.shape[0]
    res = {
        "kind": kind, "batch": b, "rows": imgs.shape[0], "shape": list(imgs.shape), "step_ms": step_ms,
        "images_per_s": b * 1e3 / step_ms,
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


def phase_eval(k1, seed: int, root: str) -> tuple[int, dict]:
    """``evaluate_model`` on 16 synthetic frames with the committed weights:
    its aggregates must equal those computed from ``process_batch`` on the
    same frames, and those with K1 swapped for its plain version.  Then
    ``evaluate_segmentation`` on the synthetic val split (from the train
    phase).  Returns K1's launches and the aggregates."""
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
    return launches, agg


# N ranks against one process.  float32 (TF32 off): the CPU test's bounds
# (tests/test_torch_mesh.py).  bfloat16 keeps 8 significant bits (2^-8 =
# 3.9e-3 a rounding) and cuDNN picks its algorithms by the batch (16 or 128
# rows a rank, 32 or 256 in one process), so an output element may round
# one step apart: bounds a few times over the differences measured on an
# H100 (loss 1.2e-4, statistics 2.1e-4, parameter norm 6.2e-6).  "grad"
# is the all-reduced gradient (max |difference| over max |gradient|):
# float32 as the statistics, bfloat16 one rounding step.  The accuracy is
# counted in samples of the global batch: a bfloat16 argmax within a
# rounding step of a tie may fall either way.
#
# Each bound is the larger of this table and twice the one-process
# result's own distance from a float64 witness of the same step (same
# weights, same augmented rows): N ranks may differ from one process by
# no more than twice what the precision alone moves one process.  Adam's
# first step moves a parameter by about ±lr whatever its gradient, and
# parameters whose gradient lies within its rounding take either sign, so
# the parameter norm's difference is a sum of many terms of either sign:
# its bound is also four times the spread such a sum has for the
# one-process step's per-parameter differences from the witness
# (``param_norm_spread``).  A control step on each rank's rows without the collectives (no
# BatchNorm or gradient all-reduce: what a lost collective gives) must
# fall outside the bounds of the gradient and the statistics.
MESH_TOL = {
    "float32": {"loss": 1e-6, "metric": 1e-6, "param_norm": 1e-6, "stats": 1e-5, "grad": 1e-5},
    "bfloat16": {"loss": 1e-3, "metric": 1e-2, "param_norm": 1e-4, "stats": 2e-3, "grad": 3.9e-3},
}
ACCURACY_SAMPLES = {"float32": 0, "bfloat16": 1}


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


@contextlib.contextmanager
def float64_kept():
    """``Tensor.float()`` leaves float64 tensors as they are: the models'
    float32 layers (BatchNorm, heads) then compute a float64 witness in
    float64 throughout."""
    import torch

    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else real(self, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = real


def parity_steps(k1, mesh, seed: int, save_dir: str, timed: int = 5, witness: bool = False) -> dict:
    """One train step of each trainer's model at full width (UNet base 32 on
    B=32 global 256² frames, ResNet18 width 64 on B=256 global squares),
    in bfloat16 over float32 master weights and in float32 (TF32 off), from
    the seeded state, on this rank's rows of the global batch, uploaded and
    augmented alone as the trainers do.  Records loss, metric, parameter
    norm and BatchNorm statistics after the step, the gradient the
    optimizer was handed (its SHA-256; rank 0 and one process write it to
    ``save_dir`` as ``<kind>_<dtype>_grad.npy``), K1's launches and its
    error against the plain version on the augmentation, then the ms of
    ``timed`` more bfloat16 steps (collectives included).  Each kind's
    augmented rows go to ``save_dir`` as ``<kind>_rank<r>_<i>.npy``.  On
    a mesh of several ranks also a ``control``: the same step on the rank's
    rows without the collectives.  ``witness``: also each kind's step in
    float64 (``<kind> float64``), and for each step the spread of its
    parameter norm's difference from the witness (``param_norm_spread``,
    see ``MESH_TOL``)."""
    import hashlib

    import numpy as np
    import torch

    from chessvision_tpu_torch import models
    from chessvision_tpu_torch.models.layers import set_compute_dtype
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.train import steps
    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch, fold_in
    from chessvision_tpu_torch.utils import full_f32

    dev = mesh.device if mesh is not None else torch.device("cuda")
    rank = mesh.rank if mesh is not None else 0

    def one_step(kind, dtype, x, y, step_mesh, tag):
        torch.manual_seed(seed)
        if kind == "unet":
            model = models.UNet(base=32)
            tx = steps.Chain([steps.ClipByGlobalNorm(1.0), steps.AddDecayedWeights(1e-8),
                              steps.inject_hyperparams(steps.rmsprop, learning_rate=3e-5, momentum=0.999, eps=1e-8)])
            step, metric = steps.make_seg_train_step(step_mesh), "dice"
        else:
            model = models.resnet18(width=64)
            tx = steps.adam(1e-3)
            step, metric = steps.make_cls_train_step(step_mesh), "accuracy"
        if dtype == torch.float64:
            model, x = model.double().to(dev), x.double()
            y = y.double() if kind == "unet" else y
        else:
            model = set_compute_dtype(model, dtype, master_weights=True).to(dev)
        state = steps.TrainState.create(mesh_lib.replicate(mesh, model), tx)
        grads = []
        state.apply_gradients = lambda g: (grads.append(torch.cat([t.detach().double().ravel() for t in g])),
                                           steps.TrainState.apply_gradients(state, g))
        with full_f32(), float64_kept() if dtype == torch.float64 else contextlib.nullcontext():
            m = step(state, x, y)
        del state.apply_gradients
        grad = grads[0].cpu().numpy()
        if dtype != torch.float64:
            grad = grad.astype(np.float32)  # the float32 gradient, exactly
        if rank == 0:
            np.save(os.path.join(save_dir, f"{tag}_grad.npy"), grad)
        stats = [b_.detach().double().cpu().numpy().ravel() for n_, b_ in state.model.named_buffers()
                 if n_.endswith(("running_mean", "running_var"))]
        rec = {"loss": float(m["loss"]), "metric": float(m[metric]),
               "param_norm": float(np.sqrt(sum(float(torch.sum(p.detach().double() ** 2)) for p in state.params))),
               "stats": np.concatenate(stats).tolist(), "grad_sha": hashlib.sha256(grad.tobytes()).hexdigest()}
        after = torch.cat([p.detach().double().ravel() for p in state.params]) if witness else None
        return rec, state, step, after

    def spread(a, b):
        """The spread of the parameter norm's relative difference if the
        per-parameter differences between ``a`` and ``b`` had random signs."""
        return float(torch.sqrt(torch.sum((a * a - b * b) ** 2)) / (2 * torch.sum(b * b)))

    out, witness_after = {}, {}
    for kind, dtype in (("unet", torch.bfloat16), ("resnet18", torch.bfloat16), ("unet", torch.float32),
                        ("resnet18", torch.float32)):
        dt = str(dtype).split(".")[-1]
        name = f"{kind} {dt}"
        if kind == "unet":
            (imgs, targets), rows, b = rows_on_card(mesh, seg_batch(seed, 32, host=True), 1)

            def augment(i):
                return augment_segmentation_batch(fold_in(seed, i), imgs, targets, rows=rows, global_batch=b)
        else:
            (imgs, targets), rows, b = rows_on_card(mesh, cls_batch(seed, 256, host=True), 1)

            def augment(i):
                return augment_classification_batch(fold_in(seed, i), imgs, rows=rows, global_batch=b), targets

        k1.launches = 0
        (x, y), calls = capture_k1(k1, lambda: augment(0))
        torch.cuda.synchronize(dev)
        launches = k1.launches
        errs = check_captured(k1, calls, f"parallel {name} augmentation")
        if dtype == torch.bfloat16:
            for i, t in enumerate((x, y) if kind == "unet" else (x,)):
                np.save(os.path.join(save_dir, f"{kind}_rank{rank}_{i}.npy"), t.cpu().numpy())
        out[name], state, step, after = one_step(kind, dtype, x, y, mesh, f"{kind}_{dt}")
        out[name].update(batch=b, k1_launches=launches,
                         k1_err=max(e for case in errs.values() for e in case.values()))
        if mesh is not None and mesh.size > 1:
            out[name]["control"] = one_step(kind, dtype, x, y, None, f"{kind}_{dt}_control")[0]
        if witness and dtype == torch.bfloat16:
            out[f"{kind} float64"], *_, witness_after[kind] = one_step(kind, torch.float64, x, y, None,
                                                                        f"{kind}_float64")
        if witness:
            out[name]["param_norm_spread"] = spread(after, witness_after[kind])
        del after
        if dtype == torch.float32 or not timed:
            continue
        step(state, x, y)["loss"].item()  # warm-up at the second step
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            step(state, x, y)["loss"].item()
        torch.cuda.synchronize(dev)
        out[name]["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
    return out


def parity_line(par: dict) -> str:
    def short(d):
        return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})

    return (f"errors {short(par['errors'])} (bounds {short(par['bounds'])}; accuracy in samples); the float64 "
            f"witness's distance from one process {short(par['one_vs_witness'])}, from the ranks "
            f"{short(par['ranks_vs_witness'])}" + (f"; control without collectives {short(par['control_errors'])}"
                                                    if par["control_errors"] else ""))


def parity_problems(label: str, name: str, recs: list[dict], one: dict, rank_dir: str, one_dir: str) -> tuple[dict, list]:
    """Hold ``recs`` (each rank's ``parity_steps`` record of ``name``)
    against the one-process record ``one[name]`` by ``MESH_TOL``, each
    bound raised to twice the one-process result's distance from the
    float64 witness ``one["<kind> float64"]``; the ranks must agree, and
    the control (no collectives) must fall outside the bounds of the
    gradient and the statistics.  Returns the numbers and the problems."""
    import numpy as np

    kind, dt = name.split()
    tol, o, w, r0 = MESH_TOL[dt], one[name], one[f"{kind} float64"], recs[0]
    grads = {"one": np.load(os.path.join(one_dir, f"{kind}_{dt}_grad.npy")),
             "witness": np.load(os.path.join(one_dir, f"{kind}_float64_grad.npy")),
             "ranks": np.load(os.path.join(rank_dir, f"{kind}_{dt}_grad.npy"))}
    if "control" in r0:
        grads["control"] = np.load(os.path.join(rank_dir, f"{kind}_{dt}_control_grad.npy"))

    def dist(key, a, b, ga, gb):
        if key == "grad":
            return rel(ga, gb)
        if key == "metric" and kind == "resnet18":  # samples of the global batch
            return abs(a[key] - b[key]) * o["batch"]
        return rel(a[key], b[key])

    res = {"errors": {}, "bounds": {}, "one_vs_witness": {}, "ranks_vs_witness": {}, "control_errors": {}}
    problems = []
    for key in tol:
        floor = ACCURACY_SAMPLES[dt] if key == "metric" and kind == "resnet18" else tol[key]
        if key == "param_norm":
            floor = max(floor, 4 * o["param_norm_spread"])
        res["one_vs_witness"][key] = dist(key, o, w, grads["one"], grads["witness"])
        res["ranks_vs_witness"][key] = dist(key, r0, w, grads["ranks"], grads["witness"])
        res["bounds"][key] = max(floor, 2 * res["one_vs_witness"][key])
        res["errors"][key] = dist(key, r0, o, grads["ranks"], grads["one"])
        if "control" in r0:
            res["control_errors"][key] = dist(key, r0["control"], o, grads["control"], grads["one"])
    for key in ("loss", "metric", "param_norm", "stats", "grad_sha"):
        if any(r[key] != r0[key] for r in recs[1:]):
            problems.append(f"(a) {name}: {key} differs between the ranks")
    bad = {k: v for k, v in res["errors"].items() if not v <= res["bounds"][k]}
    if bad:
        problems.append(f"(a) {name}: the {label} step differs from one process beyond the bounds: {bad}")
    unseen = [k for k in ("grad", "stats") if "control" in r0 and not res["control_errors"][k] > res["bounds"][k]]
    if unseen:
        problems.append(f"(a) {name}: the control without collectives stays inside the bounds of {unseen}")
    return res, problems


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
    rec["steps"] = parity_steps(k1, mesh, seed, out_dir)

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
    mesh_lib.shutdown_distributed()
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
    # one group for both command lines (their flags then find it joined): a
    # trainer's main leaves only a group it joined itself
    mesh_lib.initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
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
    mesh_lib.shutdown_distributed()
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
    one_dir = tempfile.mkdtemp(prefix="one-", dir=root)
    one = parity_steps(k1, None, seed, one_dir, witness=True)
    names = [k for k in one if not k.endswith("float64")]
    launches = sum(r["steps"][k]["k1_launches"] for r in ranks for k in r["steps"])
    launches += sum(one[k]["k1_launches"] for k in names)
    worst = 0.0
    res = {"steps": {}}
    problems = []  # (a) and (c) are both read before the phase fails
    for name in names:
        a, b, o = ranks[0]["steps"][name], ranks[1]["steps"][name], one[name]
        par, bad = parity_problems("two-rank", name, [a, b], one, out_dir, one_dir)
        problems += bad
        worst = max(worst, a["k1_err"], b["k1_err"], o["k1_err"])
        res["steps"][name] = dict(par, loss=a["loss"], metric=a["metric"])
        timing = ""
        if "step_ms" in a:
            res["steps"][name].update(mesh_step_ms=[a["step_ms"], b["step_ms"]], one_process_step_ms=o["step_ms"])
            timing = (f"; step {a['step_ms']:.2f} / {b['step_ms']:.2f} ms a rank against {o['step_ms']:.2f} ms in one "
                      f"process (two ranks share one card and stage every collective through host memory: no "
                      f"scaling is measured)")
        log(f"[parallel] (a) {name} step, 2 gloo ranks vs one process: {parity_line(par)}; equal across ranks: "
            f"{not any(p.startswith(f'(a) {name}: ') and 'between the ranks' in p for p in problems)}{timing}")

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


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module (its ``main``
    is not run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(k1, fn):
    """``fn()`` with K1 captured and counted from 0 and its printed lines
    caught: (result, captured calls, launches, lines)."""
    import io

    import torch

    buf = io.StringIO()
    k1.launches = 0
    with contextlib.redirect_stdout(buf):
        result, calls = capture_k1(k1, fn)
    torch.cuda.synchronize()
    return result, calls, k1.launches, buf.getvalue().splitlines()


def phase_launchers(k1, seed: int, root: str, card: str, frames8, agg12: dict) -> tuple[int, dict]:
    """Phase 15: the launchers outside the package.  The three examples'
    ``main()`` in this process with the committed weights in bfloat16 (the
    quickstart and the detailed example on one synthetic frame, the
    streaming example on 4 batches of 32), each FEN and found flag against
    ``process_batch`` on the same frames; the raw stream of a one-process
    ``Engine(mesh=create_mesh())`` against the mesh-free stream; ``bash
    -n`` on every ``scripts/bin/torch_*.sh``; ``torch_evaluate.sh`` on phase
    12's test root (its aggregates equal phase 12's) while
    ``torch_serve.sh --local`` starts, answers one posted frame with
    ``process_batch``'s FEN and is stopped.  Returns K1's launches (this
    process's) and the numbers."""
    import base64
    import glob
    import signal

    import cv2
    import torch

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval import render
    from chessvision_tpu_torch.parallel.mesh import create_mesh

    here = os.path.dirname(os.path.abspath(__file__))
    wrappers = sorted(glob.glob(os.path.join(here, "scripts", "bin", "torch_*.sh")))
    if len(wrappers) != 8:
        fail(f"launchers: expected 8 scripts/bin/torch_*.sh, found {wrappers}")
    for path in wrappers:
        out = subprocess.run(["bash", "-n", path], capture_output=True, text=True)
        if out.returncode != 0:
            fail(f"launchers: bash -n {path}: {out.stderr}")
    log(f"[launchers] bash -n passes on {[os.path.basename(p) for p in wrappers]}")

    # the two wrappers run as processes of their own, the server first so
    # that its start lies under the evaluation
    t0 = time.perf_counter()
    env = child_env()
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")  # the wrappers run `python`
    port = free_port()
    server_log = open(os.path.join(root, "torch_serve.log"), "w")
    server = subprocess.Popen(["bash", os.path.join(here, "scripts", "bin", "torch_serve.sh"), "--local"],
                              env=dict(env, PORT=str(port)), cwd=root, stdout=server_log,
                              stderr=subprocess.STDOUT, start_new_session=True)
    res: dict = {}
    evaluation = None
    try:
        evaluation = subprocess.Popen(
            ["bash", os.path.join(here, "scripts", "bin", "torch_evaluate.sh"), "--test-root",
             os.path.join(root, "test"), "--batch-size", "8"],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # the examples, in this process, while the wrappers start
        s = seed + 1  # a synthetic frame whose board the models find (tests/test_torch_launchers.py)
        cv = ChessVision(device="cuda")
        launches, errs = 0, {}
        qs = load_example("torch_quickstart")
        _, image, _ = qs.input_image(s)
        png = os.path.join(root, "quickstart.png")
        got, calls, n, lines = run_example(k1, lambda: qs.main(seed=s, out=png))
        want = cv.engine.process_batch(image[None])
        fen = got.position.fen if got.position is not None else ""
        n_panels = 3 + 2 * int(got.position is not None)
        shape = (render.TITLE + render.PANEL, n_panels * render.PANEL + (n_panels - 1) * render.GAP, 3)
        written = cv2.imread(png)
        if n != 2 or (got.position is not None) != bool(want.board_found[0]) or fen != want.fens[0] \
                or written is None or written.shape != shape:
            fail(f"launchers: quickstart found={got.position is not None} fen={fen!r} K1 launches {n}, comparison "
                 f"{None if written is None else written.shape}; process_batch found={bool(want.board_found[0])} "
                 f"fen={want.fens[0]!r}")
        launches += n
        errs.update(check_captured(k1, calls, "quickstart"))
        log(f"[launchers] torch_quickstart.main(): {' | '.join(lines)}; K1 launches {n}")

        de = load_example("torch_detailed_example")
        got, calls, n, lines = run_example(k1, lambda: de.main(seed=s))
        if n != 2 or got.fens != want.fens or got.board_found.tolist() != want.board_found.tolist():
            fail(f"launchers: detailed example fens={got.fens} K1 launches {n}; process_batch {want.fens}")
        launches += n
        errs.update(check_captured(k1, calls, "detailed"))
        log(f"[launchers] torch_detailed_example.main(): {len(lines)} lines, {lines[-2] if len(lines) > 1 else ''}; "
            f"K1 launches {n}")

        st = load_example("torch_streaming_throughput")
        got, calls, n, lines = run_example(k1, lambda: st.main(4, 32, seed=s))
        want32 = cv.engine.process_batch(got["batch"])
        for fens, found in zip(got["fens"], got["found"]):
            if fens != want32.fens or found.tolist() != want32.board_found.tolist():
                fail(f"launchers: streaming example FENs {fens[:2]}... differ from process_batch's {want32.fens[:2]}...")
        if n != 2 * 5:  # the warm-up batch and 4 streamed
            fail(f"launchers: streaming example K1 launches {n}, expected 10")
        launches += n
        errs.update(check_captured(k1, {"warp_twopass": calls["warp_twopass"][:2], "hat_resample": []}, "streaming"))
        res["streaming_boards_per_s"] = got["boards_per_s"]
        log(f"[launchers] torch_streaming_throughput.main(4, 32): {got['boards_per_s']:.1f} boards/s (yuv444 through "
            f"run_stream, 32 tiles of one synthetic frame, host FENs included); {card}; FENs equal process_batch's; "
            f"K1 launches {n}")

        # repair: the raw stream on a one-process mesh runs mesh-free on the card
        batches = [frames8, frames8[::-1].copy()]
        meshed = ChessVision(device="cuda", mesh=create_mesh()).engine
        plain_out = list(cv.engine.run_stream(batches, kind="raw"))
        k1.launches = 0
        mesh_out = list(meshed.run_stream(batches, kind="raw"))
        torch.cuda.synchronize()
        n = k1.launches
        bad = [k for a, b in zip(mesh_out, plain_out) for k in b
               if not (isinstance(a[k], torch.Tensor) and a[k].is_cuda and torch.equal(a[k], b[k]))]
        if n != 4 or len(mesh_out) != 2 or bad:
            fail(f"launchers: Engine(mesh=create_mesh()).run_stream(raw): K1 launches {n}, differing or host outputs {bad}")
        launches += n
        log(f"[launchers] Engine(mesh=create_mesh()) raw stream, 2 batches of 8: tensors on {mesh_out[0]['found'].device}, "
            f"equal to the mesh-free stream's; K1 launches {n}")
        del plain_out, mesh_out

        stdout, stderr = evaluation.communicate(timeout=600)
        if evaluation.returncode != 0:
            fail(f"launchers: torch_evaluate.sh exited {evaluation.returncode}:\n{stderr[-3000:]}")
        agg = json.loads(stdout[stdout.rfind("\n{") + 1 :])
        timeless = lambda a: {k: v for k, v in a.items() if not k.startswith("avg_time")}  # noqa: E731
        if timeless(agg) != timeless(agg12):
            fail(f"launchers: torch_evaluate.sh aggregates {timeless(agg)} differ from phase 12's {timeless(agg12)}")
        log(f"[launchers] torch_evaluate.sh --test-root <phase 12's> --batch-size 8: aggregates equal phase 12's "
            f"({agg['num_images']} images) in {time.perf_counter() - t0:.1f} s since the wrappers started")

        deadline = time.time() + 300
        while True:
            if server.poll() is not None:
                fail(f"launchers: torch_serve.sh exited {server.returncode}")
            try:
                if http_json(port, "/ping", None)[0] == 200:
                    break
            except OSError:
                pass
            if time.time() > deadline:
                fail("launchers: torch_serve.sh did not answer /ping in 300 s")
            time.sleep(0.5)
        log(f"[launchers] torch_serve.sh --local up on port {port} (warmed) {time.perf_counter() - t0:.1f} s after "
            f"the wrappers started")
        want1 = cv.engine.process_batch(image[None], lite=True)
        status, body = http_json(port, "/cv_algo/", {"image": base64.b64encode(ppm_bytes(image)).decode()})
        if bool(want1.board_found[0]):
            ok = status == 200 and body.get("fen") == want1.fens[0]
        else:
            ok = status == 400 and body.get("error") == "No chessboard detected"
        if not ok:
            fail(f"launchers: torch_serve.sh answered {status} {body}, process_batch gave {want1.fens[0]!r}")
        log(f"[launchers] torch_serve.sh answered {status} fen={body.get('fen')!r} (process_batch's)")
    finally:
        if server.poll() is None:
            os.killpg(server.pid, signal.SIGTERM)
            try:
                server.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(server.pid, signal.SIGKILL)
                server.wait()
        server_log.close()
        if evaluation is not None and evaluation.poll() is None:
            evaluation.kill()
            evaluation.wait()
    worst = max(e for case in errs.values() for e in case.values())
    res.update(k1_max_abs_err=worst, seconds=time.perf_counter() - t0, launches=launches)
    log(f"[launchers] done in {res['seconds']:.1f} s; K1 launches {launches}, max |kernel - plain| {worst}")
    return launches, res


# -- 16. across cards -------------------------------------------------------------------------


def active_contexts() -> list[int]:
    """The CUDA device ordinals on which this process holds an active
    primary context, from libcuda (``cuDevicePrimaryCtxGetState``): what
    a process costs a card, whatever torch itself tracks."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    p_int, p_uint = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint)
    for name, args in (("cuInit", [ctypes.c_uint]), ("cuDeviceGetCount", [p_int]),
                       ("cuDeviceGet", [p_int, ctypes.c_int]),
                       ("cuDevicePrimaryCtxGetState", [ctypes.c_int, p_uint, p_int])):
        getattr(cuda, name).argtypes, getattr(cuda, name).restype = args, ctypes.c_int
    n = ctypes.c_int()
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(n)) != 0:
        fail("libcuda did not initialize")
    out = []
    for i in range(n.value):
        dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        if cuda.cuDeviceGet(ctypes.byref(dev), i) != 0 or \
                cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(active)) != 0:
            fail(f"libcuda did not report card {i}")
        if active.value:
            out.append(i)
    return out


def card_uuid(dev) -> str:
    """The card's UUID as nvidia-smi prints it (``GPU-…``), "" where torch
    does not report it."""
    import torch

    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return "" if uuid is None else "GPU-" + str(uuid).removeprefix("GPU-")


def card_bus(dev) -> str:
    """The card's PCI address as nvidia-smi prints it (00000000:BB:DD.0)."""
    import torch

    p = torch.cuda.get_device_properties(dev)
    return f"{getattr(p, 'pci_domain_id', 0):08X}:{getattr(p, 'pci_bus_id', 0):02X}:{getattr(p, 'pci_device_id', 0):02X}.0"


def smi_apps() -> tuple[dict, list[str]]:
    """nvidia-smi's compute processes as {pid: {gpu bus id: used MiB}}, and
    every card as "index bus-id: used MiB" (bus ids, because a sealed
    machine may redact the UUIDs)."""
    def query(*args):
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60)
        return [[x.strip() for x in line.split(",")] for line in out.stdout.strip().splitlines() if line.strip()]

    apps: dict = {}
    for pid, bus, mem in query("--query-compute-apps=pid,gpu_bus_id,used_memory"):
        if pid.isdigit():
            apps.setdefault(int(pid), {})[bus] = mem
    return apps, [f"{i} {bus}: {mem} MiB" for i, bus, mem in query("--query-gpu=index,pci.bus_id,memory.used")]


def hold_until_released(out_dir: str, rank: int, timeout: float = 600.0) -> None:
    """Tell the parent this rank is ready (``ready<rank>``) and wait, still
    holding its memory, until it writes ``release``."""
    open(os.path.join(out_dir, f"ready{rank}"), "w").close()
    deadline = time.time() + timeout
    while not os.path.exists(os.path.join(out_dir, "release")):
        if time.time() > deadline:
            fail(f"rank {rank}: the parent never released the ranks")
        time.sleep(0.05)


def multicard_child(rank: int, world: int, port: int, out_dir: str, seed: int) -> int:
    """One rank of phase 16 on ``cuda:<rank>`` over NCCL, as a trainer's
    flags start it: (a) the parity steps (augmented rows written for the
    parent), (b) the scaling steps, (d) ``Engine(mesh=…)`` and its raw
    stream at B=128, (e) K1 captured on this card's augmentation inputs,
    held against its plain version and timed, (f) the cards this process
    holds a context on.  Writes ``rank<rank>.json``, then holds its memory
    until the parent has read nvidia-smi."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chessvision_tpu_torch import constants, profiling
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.parallel import mesh as mesh_lib
    from chessvision_tpu_torch.synthetic import board_frames
    from chessvision_tpu_torch.train.augment import augment_classification_batch, augment_segmentation_batch

    t_start = time.perf_counter()
    mesh_lib.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="nccl")
    mesh = mesh_lib.create_mesh(device="cuda")
    dev = mesh.device
    rec = {"rank": mesh.rank, "size": mesh.size, "device": str(dev), "backend": mesh.backend, "pid": os.getpid(),
           "current_device": torch.cuda.current_device(), "uuid": card_uuid(dev), "bus": card_bus(dev),
           "join_s": time.perf_counter() - t_start}
    launches = 0

    # (a) parity at two seeds (the second untimed), (b) scaling
    rec["steps"] = {}
    for s in (seed, seed + 1):
        os.makedirs(os.path.join(out_dir, f"seed{s}"), exist_ok=True)
        rec["steps"][str(s)] = parity_steps(k1, mesh, s, os.path.join(out_dir, f"seed{s}"), timed=5 if s == seed else 0)
        launches += sum(v["k1_launches"] for v in rec["steps"][str(s)].values())
    rec["scaling"] = {}
    for kind in ("unet", "resnet18"):
        for mode in ("strong", "weak"):
            t = time_train_steps(k1, kind, seed, mesh=mesh, per_rank=mode == "weak")
            launches += round(t["k1_launches_per_step"] * 20)
            rec["scaling"][f"{kind} {mode}"] = t

    # (d) inference over the mesh, and the raw stream on the same engine
    uniq = board_frames(seed + 1, 32)[0]
    frames128 = np.concatenate([uniq] * 4)
    cv = ChessVision(device="cuda", mesh=mesh)
    cv.engine.process_batch(frames128)  # warm-up
    torch.cuda.synchronize(dev)
    k1.launches = 0
    res, calls = capture_k1(k1, lambda: cv.engine.process_batch(frames128))
    torch.cuda.synchronize(dev)
    rec["engine_k1_launches"] = k1.launches
    launches += k1.launches
    errs = check_captured(k1, calls, "multicard engine")
    rec["engine_rows"] = int(calls["warp_twopass"][0][0].shape[0])
    del calls
    rec["fens"], rec["found"] = list(res.fens), res.board_found.tolist()
    np.save(os.path.join(out_dir, f"quads{rank}.npy"), res.quadrangle)
    rec["engine_ms"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        cv.engine.process_batch(frames128)
        rec["engine_ms"].append((time.perf_counter() - t0) * 1e3)
    batches = [frames128, np.roll(frames128, 5, axis=0)]
    k1.launches = 0
    outs = list(cv.engine.run_stream(batches, kind="raw"))
    torch.cuda.synchronize(dev)
    rec["stream_k1_launches"] = k1.launches
    launches += k1.launches
    rec["stream"] = [{"fens": fens_of(engine_mod, constants, o), "found": o["found"].cpu().tolist(),
                      "device": str(o["found"].device)} for o in outs]
    for i, o in enumerate(outs):
        np.save(os.path.join(out_dir, f"stream{rank}_{i}.npy"), o["quadrangle"].cpu().numpy())
    del outs

    # (e) K1 on this card at the per-rank augmentation shapes
    (imgs, masks), rows, b = rows_on_card(mesh, seg_batch(seed, 32, host=True), 1)
    (squares, _), crow, cb = rows_on_card(mesh, cls_batch(seed, 256, host=True), 1)
    k1.launches = 0
    _, seg_calls = capture_k1(k1, lambda: augment_segmentation_batch(
        seed + 1, imgs, masks, illum_gradient=True, rows=rows, global_batch=b))
    _, cls_calls = capture_k1(k1, lambda: augment_classification_batch(
        seed + 1, squares, cutout=True, dim=True, fade=True, rows=crow, global_batch=cb))
    torch.cuda.synchronize(dev)
    rec["augment_k1_launches"] = k1.launches
    launches += k1.launches
    errs.update(check_captured(k1, seg_calls, f"multicard segmentation cuda:{rank}"))
    errs.update(check_captured(k1, cls_calls, f"multicard classifier cuda:{rank}"))
    rec["k1_times"] = {
        "segmentation": [time_k1(k1, *a, plain_iters=2) for a in seg_calls["warp_twopass"]],
        "classifier": [time_k1(k1, *a, plain_iters=2) for a in cls_calls["warp_twopass"]],
    }
    rec["k1_err"] = max([e for case in errs.values() for e in case.values()]
                        + [v["k1_err"] for by_seed in rec["steps"].values() for v in by_seed.values()])
    rec["k1_launches"] = launches

    # (f) the cards this process holds a context on, after a barrier and a
    # timed call (both act on "the" device where a process is not bound)
    torch.distributed.barrier()
    profiling.wall_ms(lambda: None, iters=1)
    rec["contexts"] = active_contexts()
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    hold_until_released(out_dir, rank)
    mesh_lib.shutdown_distributed()
    return 0


def run_held_ranks(mode: str, world: int, argv_of, out_dir: str, timeout: int, extra_env: dict | None = None):
    """Start ``world`` ranks of this script's ``mode``, wait until every
    one has written ``ready<r>`` (a rank that exits first fails the phase),
    read nvidia-smi while they hold their memory, release them and wait
    for every one to exit 0.  Returns (outputs, nvidia-smi's apps, the
    cards' UUIDs, the cards this process held contexts on meanwhile).
    Every rank is stopped before this returns."""
    env = dict(child_env(), **(extra_env or {}))
    procs = []
    logs = []
    try:
        for r in range(world):
            logs.append(open(os.path.join(out_dir, f"{mode}{r}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), f"--{mode}", *argv_of(r)],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + timeout
        while not all(os.path.exists(os.path.join(out_dir, f"ready{r}")) for r in range(world)):
            bad = [(r, p.returncode) for r, p in enumerate(procs) if p.poll() is not None]
            if bad or time.time() > deadline:
                for lg in logs:
                    lg.seek(0)
                tails = "\n".join(f"--- rank {r}:\n{lg.read()[-3000:]}" for r, lg in enumerate(logs))
                fail(f"{mode}: rank(s) {bad or 'all'} {'exited before ready' if bad else 'timed out'}:\n{tails}")
            time.sleep(0.1)
        apps, cards = smi_apps()
        open(os.path.join(out_dir, "release"), "w").close()
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                fail(f"{mode}: rank {r} did not exit within 120 s of its release (teardown hang)")
        outs = []
        for lg in logs:
            lg.seek(0)
            outs.append(lg.read())
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            fail(f"{mode}: rank(s) exited non-zero {bad}:\n" + "\n".join(o[-3000:] for o in outs))
        return outs, apps, cards
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lg in logs:
            lg.close()


def binding_problems(recs: list[dict], apps: dict) -> tuple[list, str]:
    """What is wrong with where the ranks hold memory.  Each rank must hold
    a context on its own card only, by libcuda's record of its own
    process (``active_contexts``); where nvidia-smi lists the ranks' PIDs,
    each must hold memory on its own card's bus only.  (A sealed machine's
    nvidia-smi may list PIDs of another namespace: then it cannot say
    which process holds what, and only its per-card totals are kept.)"""
    problems = []
    for r in recs:
        own = int(r["device"].split(":")[1])
        if r["contexts"] != [own]:
            problems.append(f"rank {r['rank']} holds contexts on cards {r['contexts']}, expected [{own}]")
    seen = {r["pid"] for r in recs} & set(apps)
    if not seen:
        return problems, f"nvidia-smi lists none of the ranks' PIDs (it shows {sorted(apps)}: another PID namespace)"
    for r in recs:
        held = sorted(b.lower() for b in apps.get(r["pid"], {}))
        if held != [r["bus"].lower()]:
            problems.append(f"rank {r['rank']} (pid {r['pid']}) holds memory on {held}, expected [{r['bus']}]")
    return problems, f"nvidia-smi lists {len(seen)} of the ranks' PIDs"


def launch_torchrun(cmd: list[str], env: dict, cwd: str, log_path: str, timeout: int) -> float:
    """Run a torchrun command line in its own process group; fail unless it
    exits 0 within ``timeout`` (the group is killed then).  Returns its
    seconds."""
    import signal

    t0 = time.perf_counter()
    with open(log_path, "w") as lg:
        proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=lg, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    if rc != 0:
        with open(log_path) as lg:
            tail = lg.read()[-4000:]
        fail(f"multicard (c): {' '.join(cmd[:6])} ... {'timed out' if rc is None else f'exited {rc}'}:\n{tail}")
    return time.perf_counter() - t0


def newest_checkpoint(store: str, project: str) -> str:
    import glob

    found = sorted(glob.glob(os.path.join(store, "projects", project, "runs", "*", "bulk", "checkpoint.npz")),
                   key=os.path.getmtime)
    if not found:
        fail(f"multicard (c): no checkpoint of {project} in {store}")
    return found[-1]


def phase_multicard(k1, seed: int, root: str, world: int, card: str, res128=None) -> tuple[dict, dict]:
    """Phase 16: ``world`` ranks over NCCL, one per card.  (a) at two seeds,
    each trainer's full-width step against one process on the same global
    batch (``parity_problems``), equal across ranks, and each rank's augmented rows
    equal to the one-process augmentation's, bit for bit; (b) step ms a
    rank and images/s over the ranks, strong (the shipping batch split)
    and weak (the shipping batch on each rank), beside one process on one
    card; (c) ``torch_train_distributed.sh`` and ``torchrun -m
    …train_classifier`` through torchrun's environment, one epoch each,
    rank 0's checkpoints served; (d) ``Engine(mesh=…)`` at B=128 and its
    raw stream against one process; (e) K1 on every card against its plain
    version; (f) each rank's memory on its own card only.  Returns K1's launches by
    card and the numbers."""
    import numpy as np

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import (board_frames, write_segmentation_dataset, write_squares_dataset,
                                                 write_test_root)

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="multicard-", dir=root)
    port = free_port()
    _, apps, smi_cards = run_held_ranks("multicard-child", world,
                                    lambda r: [str(r), str(world), str(port), out_dir, str(seed)], out_dir, 1500)
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(world)]
    log(f"[multicard] {world} ranks done in {time.perf_counter() - t_phase:.1f} s; joined the group in "
        f"{[round(r['join_s'], 1) for r in recs]} s; {card}")
    problems = []
    devices = [r["device"] for r in recs]
    if [r["backend"] for r in recs] != ["nccl"] * world or devices != [f"cuda:{r}" for r in range(world)] \
            or len(set(r["uuid"] for r in recs)) != world or [r["current_device"] for r in recs] != list(range(world)):
        problems.append(f"backends {[r['backend'] for r in recs]}, devices {devices}, current devices "
                        f"{[r['current_device'] for r in recs]}, uuids {[r['uuid'] for r in recs]}: expected nccl "
                        f"on {world} distinct cards, each its rank's current device")

    # (a) parity at two seeds, against one process on cuda:0 after the ranks
    res: dict = {"world": world, "devices": devices, "steps": {}, "scaling": {}}
    rows_equal = {}
    for s in (seed, seed + 1):
        ref_dir, rank_dir = tempfile.mkdtemp(prefix="one-", dir=root), os.path.join(out_dir, f"seed{s}")
        one = parity_steps(k1, None, s, ref_dir, timed=5 if s == seed else 0, witness=True)
        for name in (k for k in one if not k.endswith("float64")):
            ranks = [r["steps"][str(s)][name] for r in recs]
            par, bad = parity_problems(f"{world}-rank", name, ranks, one, rank_dir, ref_dir)
            problems += [f"seed {s} {p}" for p in bad]
            res["steps"][f"{name} seed {s}"] = dict(par, loss=ranks[0]["loss"])
            if "step_ms" in one[name]:
                res["steps"][f"{name} seed {s}"].update(step_ms=[r["step_ms"] for r in ranks],
                                                        one_process_step_ms=one[name]["step_ms"])
            log(f"[multicard] (a) seed {s}, {name} step, {world} NCCL ranks vs one process: {parity_line(par)}; equal "
                f"across ranks: {not any('between the ranks' in p for p in bad)}")
        for kind, b, n_t in (("unet", 32, 2), ("resnet18", 256, 1)):
            for i in range(n_t):
                want = np.load(os.path.join(ref_dir, f"{kind}_rank0_{i}.npy"))
                for r in range(world):
                    per, extra = divmod(b, world)
                    start = r * per + min(r, extra)
                    got = np.load(os.path.join(rank_dir, f"{kind}_rank{r}_{i}.npy"))
                    same = got.shape == want[start : start + len(got)].shape and np.array_equal(
                        got, want[start : start + len(got)])
                    rows_equal[f"seed {s} {kind} tensor {i} rank {r}"] = same
                    if not same:
                        problems.append(f"(a) seed {s} {kind} tensor {i}: rank {r}'s augmented rows differ from the "
                                        f"one-process augmentation's rows {start}:{start + len(got)}")
        shutil.rmtree(ref_dir)
    res["augmented_rows_bit_equal"] = all(rows_equal.values())
    log(f"[multicard] (a) every rank's augmented rows equal the one-process augmentation's, bit for bit: "
        f"{res['augmented_rows_bit_equal']} ({len(rows_equal)} tensors)")
    one_timing = {kind: time_train_steps(k1, kind, seed) for kind in ("unet", "resnet18")}

    # (b) scaling
    for kind in ("unet", "resnet18"):
        o = one_timing[kind]
        for mode in ("strong", "weak"):
            ts = [r["scaling"][f"{kind} {mode}"] for r in recs]
            slowest = max(t["step_ms"] for t in ts)
            row = {"step_ms": [t["step_ms"] for t in ts], "rows_a_rank": ts[0]["rows"], "global_batch": ts[0]["batch"],
                   "images_per_s": ts[0]["batch"] * 1e3 / slowest, "tflops_per_s_all": sum(t["tflops_per_s"] for t in ts),
                   "one_process_step_ms": o["step_ms"], "one_process_images_per_s": o["images_per_s"],
                   "speedup": ts[0]["batch"] * 1e3 / slowest / o["images_per_s"]}
            res["scaling"][f"{kind} {mode}"] = row
            log(f"[multicard] (b) {kind} {mode}: {world} ranks x {row['rows_a_rank']} rows (global {row['global_batch']}) "
                f"step {[round(x, 2) for x in row['step_ms']]} ms a rank -> {row['images_per_s']:.1f} images/s, "
                f"{row['tflops_per_s_all']:.1f} TFLOP/s over the ranks; one process on one card, B={o['batch']}: "
                f"{o['step_ms']:.2f} ms, {o['images_per_s']:.1f} images/s; speedup {row['speedup']:.2f}x; {card}")
    res["one_process_timing"] = one_timing

    # (d) inference
    uniq = board_frames(seed + 1, 32)[0]
    frames128 = np.concatenate([uniq] * 4)
    cv = ChessVision(device="cuda")
    if res128 is None:
        cv.engine.process_batch(frames128)  # warm-up at this batch
        res128 = cv.engine.process_batch(frames128)
    rolled = {"fens": [str(f) for f in np.roll(np.asarray(res128.fens), 5)],
              "found": np.roll(res128.board_found, 5).tolist(),
              "quads": np.roll(res128.quadrangle, 5, axis=0)}
    want_stream = [{"fens": list(res128.fens), "found": res128.board_found.tolist(), "quads": res128.quadrangle},
                   rolled]
    for r in recs:
        quads = np.load(os.path.join(out_dir, f"quads{r['rank']}.npy"))
        if not (r["fens"] == list(res128.fens) and r["found"] == res128.board_found.tolist()
                and np.array_equal(quads, res128.quadrangle)):
            problems.append(f"(d) rank {r['rank']}: Engine(mesh) differs from the one-process B=128 result (FENs equal "
                            f"{sum(a == b for a, b in zip(r['fens'], res128.fens))}/128, max quad diff "
                            f"{float(np.abs(quads - res128.quadrangle).max())})")
        for i, (got, want) in enumerate(zip(r["stream"], want_stream)):
            q = np.load(os.path.join(out_dir, f"stream{r['rank']}_{i}.npy"))
            if not (got["fens"] == want["fens"] and got["found"] == want["found"] and np.array_equal(q, want["quads"])
                    and got["device"] == r["device"]):
                problems.append(f"(d) rank {r['rank']}: raw stream batch {i} on {got['device']} differs from the "
                                f"one-process result")
        if r["engine_k1_launches"] != 2 or r["stream_k1_launches"] != 4:
            problems.append(f"(d) rank {r['rank']}: K1 launches {r['engine_k1_launches']} (engine, expected 2), "
                            f"{r['stream_k1_launches']} (stream, expected 4)")
    res["engine_ms"] = [r["engine_ms"] for r in recs]
    log(f"[multicard] (d) Engine(mesh={world} NCCL ranks).process_batch B=128 ({recs[0]['engine_rows']} rows a rank): "
        f"FENs, found and quads {'equal' if not any(p.startswith('(d)') for p in problems) else 'DIFFER from'} the "
        f"one-process result on every rank, raw stream of 2 batches of 128 too; ms a call by rank "
        f"{[[round(x, 1) for x in t] for t in res['engine_ms']]}; {card}")

    # (e) K1 on every card
    launches_by_card = {r["device"]: r["k1_launches"] for r in recs}
    worst = max(r["k1_err"] for r in recs)
    res["k1"] = {"launches_by_card": launches_by_card, "max_abs_err": worst, "times": {}}
    for r in recs:
        t = {name: {k: sum(c[k] for c in calls) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                           "two_kernel_floor_ms")} | {"shapes": [c["shape"] for c in calls]}
             for name, calls in r["k1_times"].items()}
        res["k1"]["times"][r["device"]] = t
        log(f"[multicard] (e) K1 on {r['device']}: max |kernel - plain| {r['k1_err']}, launches {r['k1_launches']}; "
            f"per-rank augmentation shapes: segmentation {t['segmentation']['shapes']} {t['segmentation']['ms']:.4f} ms "
            f"(grid_sample {t['segmentation']['library_ms']:.4f}, bound {t['segmentation']['bound_ms']:.4f}), "
            f"classifier {t['classifier']['shapes']} {t['classifier']['ms']:.4f} ms (grid_sample "
            f"{t['classifier']['library_ms']:.4f}, bound {t['classifier']['bound_ms']:.4f}, plain "
            f"{t['classifier']['plain_ms']:.3f})")
    if not worst <= K1_TOL:
        problems.append(f"(e) K1 differs from its plain version by {worst}")

    # (f) binding
    bind, how = binding_problems(recs, apps)
    problems += [f"(f) {p}" for p in bind]
    res["binding"] = {"contexts": {r["device"]: r["contexts"] for r in recs}, "how": how, "ok": not bind,
                      "smi_apps": {str(k): v for k, v in apps.items()}, "smi_cards": smi_cards}
    log(f"[multicard] (f) the cards each rank holds a context on (libcuda's record): "
        f"{[r['contexts'] for r in recs]}; {how}; memory in use by card while the ranks were alive {smi_cards}; "
        f"each rank on its own card only: {not bind}")

    # (c) the launchers through torchrun's environment
    here = os.path.dirname(os.path.abspath(__file__))
    data_root = os.path.join(root, "multicard-data")
    store = os.path.join(root, "multicard-store")
    t0 = time.perf_counter()
    write_segmentation_dataset(data_root, 96, seed)
    write_squares_dataset(data_root, 80, 20, seed)
    write_test_root(os.path.join(data_root, "test"), 16, seed)
    env = dict(child_env(), CVTPU_DATA_ROOT=data_root, CVTPU_STORE_ROOT=store, NPROC=str(world),
               TORCHRUN_ARGS=f"--master-port {free_port()}")
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")
    log(f"[multicard] (c) wrote the synthetic datasets in {time.perf_counter() - t0:.1f} s")
    res["launchers"] = {}
    for kind, cmd, project in (
        ("unet", ["bash", os.path.join(here, "scripts", "bin", "torch_train_distributed.sh"), "--epochs", "1"],
         "chessvision-segmentation"),
        ("resnet18", ["torchrun", "--nproc-per-node", str(world), "--master-port", str(free_port()), "-m",
                      "chessvision_tpu_torch.train.train_classifier", "--epochs", "1"], "chessvision-classification"),
    ):
        secs = launch_torchrun(cmd, env, here, os.path.join(root, f"torchrun-{kind}.log"), 600)
        ckpt = newest_checkpoint(store, project)
        res["launchers"][kind] = {"seconds": secs, "checkpoint": ckpt}
        with open(os.path.join(root, f"torchrun-{kind}.log")) as lg:
            text = lg.read()
        log(f"[multicard] (c) {' '.join(os.path.basename(c) for c in cmd[:4])} ... --epochs 1: every process exited 0 "
            f"in {secs:.1f} s over {world} ranks; rank 0's checkpoint {ckpt}; log tail: {text.strip()[-300:]!r}")
    served = ChessVision(board_extractor_weights=res["launchers"]["unet"]["checkpoint"],
                         classifier_weights=res["launchers"]["resnet18"]["checkpoint"], device="cuda")
    out = served.engine.process_batch(frames128[:8])
    if not (np.isfinite(out.probabilities).all() and np.isfinite(out.logits).all()):
        problems.append("(c) rank 0's checkpoints do not serve finite outputs")
    log(f"[multicard] (c) ChessVision on rank 0's checkpoints, B=8: finite outputs, found {int(out.board_found.sum())}/8")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[multicard] done in {res['seconds']:.1f} s; K1 launches by card {json.dumps(launches_by_card)}, "
        f"max |kernel - plain| {worst}")
    if problems:
        fail("multicard: " + "; ".join(problems))
    return launches_by_card, res


# -- 17. camera-size photos ----------------------------------------------------------------------

# (h, w) of the photos: 12 MP landscape and portrait, 48 MP (source rows past
# the 7 264 floats whose 8 rows fit a pass-1 block's shared memory) and an
# odd size (pass 1's scalar branch)
PHOTO_SIZES = {"12MP": (3024, 4032), "12MP portrait": (4032, 3024), "48MP": (6048, 8064), "odd": (3023, 4031)}


def plain_rule(got, plain) -> list[str]:
    """Phase 3's rule between a result and the plain-K1 path's: the found
    flags and FENs equal, the boards within 1 gray level on at most 0.1% of
    pixels (the kernel is expected bit-exact, which gives 0).  What breaks it."""
    import numpy as np

    problems = []
    if not (got.board_found == plain.board_found).all():
        problems.append(f"found {got.board_found.tolist()} vs {plain.board_found.tolist()}")
    if got.fens != plain.fens:
        problems.append(f"FENs {got.fens} vs {plain.fens}")
    diff = np.abs(got.board_image.astype(int) - plain.board_image.astype(int))
    if diff.size and (diff.max() > 1 or np.mean(diff > 0) > 1e-3):
        problems.append(f"boards: max {int(diff.max())}, share {float(np.mean(diff > 0))}")
    return problems


def phase_photos(k1, cv, seed: int) -> tuple[int, dict]:
    """Phase 17: the main path on camera-size photos (``photo_frames``,
    bfloat16, refine="arbitrate").  The server first, so that its posts pay
    their shapes' first call (it warms 512² only): a 12 MP and a 48 MP JPEG
    posted twice each.  Then ``comp`` and ``gray`` on the card against
    ``preprocess_images`` on the CPU (bit for bit), ``process_image`` once
    at each size against ``process_batch`` of the frame, ``process_batch``
    at B=4 of 12 MP frames (full and lite) and at B=2 of 48 MP; every
    pipeline call 2 K1 launches, its ``warp_twopass`` call held against the
    plain version, and its result against the plain-K1 path's by phase 3's
    rule; served FENs against ``process_batch``'s on the decoded frames.
    Then the times: ``process_image`` p50 at 12 and 48 MP, ``process_batch``
    B=4 at 12 MP, the upload, the stages of a B=1 call at 12 and 48 MP, K1
    at each width.  Returns K1's launches over
    the pipeline calls and the phase's record."""
    import base64
    import shutil
    import threading

    import cv2
    import numpy as np
    import torch

    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch import profiling
    from chessvision_tpu_torch.ops.resize import resize
    from chessvision_tpu_torch.serve.server import serve
    from chessvision_tpu_torch.synthetic import photo_frames
    from chessvision_tpu_torch.utils import full_f32

    t_phase = time.perf_counter()
    engine = cv.engine
    frames = {name: photo_frames(seed + 17 + i, 1, *hw)[0] for i, (name, hw) in enumerate(PHOTO_SIZES.items())}
    batch12 = np.concatenate([frames["12MP"], photo_frames(seed + 30, 3, *PHOTO_SIZES["12MP"])[0]])
    batch48 = np.concatenate([frames["48MP"], photo_frames(seed + 31, 1, *PHOTO_SIZES["48MP"])[0]])
    rec = {"frames_s": time.perf_counter() - t_phase, "errors": {}, "routes": {},
           "launches_by_kernel": dict.fromkeys(k1.kernel_launches, 0)}
    launches = 0
    k1_args = {}

    def pipeline(label: str, fn):
        """``fn()``, one pipeline call: K1 counted from 0 and captured; one
        ``warp_twopass`` call, one launch a kernel of the route
        ``warp_plan`` names, the captured call held against the plain
        version."""
        nonlocal launches
        k1.zero_launches()
        t = time.perf_counter()
        out, calls = capture_k1(k1, fn)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        by_kernel = dict(k1.kernel_launches)
        routes = [k1.warp_plan(*a[0].shape, a[2], a[3]) for a in calls["warp_twopass"]]
        kernels = [name for r in routes for name in k1.ROUTE_KERNELS[r]]
        if len(routes) != 1 or by_kernel != {name: kernels.count(name) for name in by_kernel}:
            fail(f"photos: {label}: expected one warp_twopass call launching its route's kernels, got routes "
                 f"{routes} and launches {by_kernel} in {({k: len(v) for k, v in calls.items()})}")
        launches += k1.launches
        for name, n in by_kernel.items():
            rec["launches_by_kernel"][name] += n
        rec["routes"][label] = routes[0]
        rec["errors"].update(check_captured(k1, calls, f"photos {label}"))
        k1_args.setdefault(label, calls["warp_twopass"][0])
        return out, ms

    # the server, its shapes cold
    jpegs = {name: cv2.imencode(".jpg", frames[name][0], [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
             for name in ("12MP", "48MP")}
    upload_root = tempfile.mkdtemp(prefix="cv_uploads_")
    server = serve(port=0, local=True, cv_model=cv, upload_root=upload_root, warmup=True)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    served = {}
    try:
        for name, body in jpegs.items():
            payload = {"image": base64.b64encode(body).decode()}
            for attempt in ("cold", "warm"):
                (status, reply), ms = pipeline(f"server {name} {attempt}", lambda p=payload: http_json(port, "/cv_algo/", p))
                served[name, attempt] = (status, reply, ms)
    finally:
        server.shutdown()
        server.server_close()
        shutil.rmtree(upload_root, ignore_errors=True)
    for name, body in jpegs.items():
        decoded = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        want = engine.process_batch(decoded[None], lite=True)
        for attempt in ("cold", "warm"):
            status, reply, _ = served[name, attempt]
            ok = (status == 200 and reply["fen"] == want.fens[0]) if want.board_found[0] else (
                status == 400 and reply["error"] == "No chessboard detected")
            if not ok:
                fail(f"photos: /cv_algo/ {name} {attempt}: {status} {reply}, process_batch on the decoded frame "
                     f"gave found={bool(want.board_found[0])} {want.fens[0]!r}")
    rec["server"] = {f"{name} {attempt}": {"status": v[0], "ms": v[2], "jpeg_mb": len(jpegs[name]) / 1e6}
                     for (name, attempt), v in served.items()}
    log(f"[photos] server: " + ", ".join(f"{k} {v['status']} in {v['ms']:.1f} ms ({v['jpeg_mb']:.1f} MB JPEG)"
                                         for k, v in rec["server"].items()) + "; FENs equal process_batch's")

    # the front half: comp and gray on the card against the CPU, on every
    # photo of the phase and on sizes whose area boxes are whole but not a
    # power of two (4:3 at 768×1024 and 1536×2048: 12 and 48 source pixels
    # a box, so that about one value in twelve is an exact .5 before
    # rounding, 768²: 9)
    front = {**frames, "12MP B=4 rest": batch12[1:], "48MP B=2 rest": batch48[1:],
             "768x1024": photo_frames(seed + 32, 4, 768, 1024)[0], "1536x2048": photo_frames(seed + 33, 2, 1536, 2048)[0],
             "768x768": photo_frames(seed + 34, 2, 768, 768)[0]}
    rec["front"] = {}
    for name, f in front.items():
        x = torch.from_numpy(f)
        comp_cpu, gray_cpu = engine_mod.preprocess_images(x)
        float_cpu = resize(x, (256, 256))
        with torch.inference_mode(), full_f32():
            comp_gpu, gray_gpu = (t.cpu() for t in engine_mod.preprocess_images(x.cuda()))
            float_gpu = resize(x.cuda(), (256, 256)).cpu()
        rec["front"][name] = {
            "frames": len(f),
            "comp_pixels_differ": int((comp_gpu != comp_cpu).sum()),
            "gray_pixels_differ": int((gray_gpu != gray_cpu).sum()),
            "resize_float_differ": int((float_gpu != float_cpu).sum()),
            "resize_float_max_diff": max_err(float_gpu, float_cpu),
        }
    log(f"[photos] comp/gray on the card against the CPU: {json.dumps(rec['front'])}")
    if any(v["comp_pixels_differ"] or v["gray_pixels_differ"] for v in rec["front"].values()):
        fail(f"photos: comp or gray on the card differ from the CPU's: {json.dumps(rec['front'])}")

    # process_image at each size, against process_batch and the plain K1
    singles, cold = {}, {}
    for name, f in frames.items():
        singles[name], cold[name] = pipeline(f"process_image {name}", lambda f=f: cv.process_image(f[0]))
        batch, _ = pipeline(f"process_batch {name} B=1", lambda f=f: engine.process_batch(f))
        one = singles[name]
        found = one.position is not None
        if found != bool(batch.board_found[0]) or (one.position.fen if found else "") != batch.fens[0] or (
                found and not (np.array_equal(one.board_extraction.board_image, batch.board_image[0])
                               and np.array_equal(one.board_extraction.quadrangle, batch.quadrangle[0]))):
            fail(f"photos: process_image {name} differs from process_batch of the frame")
        problems = plain_rule(batch, with_plain_k1(k1, lambda f=f: engine.process_batch(f)))
        if problems:
            fail(f"photos: process_batch {name} differs from the plain-K1 path: {problems}")
    rec["process_image"] = {name: {"found": one.position is not None, "fen": one.position.fen if one.position else "",
                                   "quad": np.round(one.board_extraction.quadrangle, 1).tolist()
                                   if one.board_extraction.quadrangle is not None else None,
                                   "first_call_ms": cold[name]}
                            for name, one in singles.items()}
    log(f"[photos] process_image: {json.dumps(rec['process_image'])}")

    # the batches
    full12, _ = pipeline("process_batch 12MP B=4", lambda: engine.process_batch(batch12))
    lite12, _ = pipeline("process_batch 12MP B=4 lite", lambda: engine.process_batch(batch12, lite=True))
    full48, _ = pipeline("process_batch 48MP B=2", lambda: engine.process_batch(batch48))
    if lite12.fens != full12.fens or not (lite12.board_found == full12.board_found).all():
        fail("photos: lite FENs differ from full FENs at 12 MP B=4")
    for label, got, frames_b in (("12MP B=4", full12, batch12), ("48MP B=2", full48, batch48)):
        problems = plain_rule(got, with_plain_k1(k1, lambda fb=frames_b: engine.process_batch(fb)))
        if problems:
            fail(f"photos: process_batch {label} differs from the plain-K1 path: {problems}")
    for label, got, name in (("12MP B=4", full12, "12MP"), ("48MP B=2", full48, "48MP")):
        one = singles[name]
        if (one.position is not None) != bool(got.board_found[0]) or (
                one.position.fen if one.position else "") != got.fens[0]:
            fail(f"photos: process_image {name} disagrees with process_batch {label} on its frame")
    rec["batches"] = {"12MP B=4": {"found": full12.board_found.tolist(), "fens": full12.fens},
                      "48MP B=2": {"found": full48.board_found.tolist(), "fens": full48.fens}}
    log(f"[photos] batches: {json.dumps(rec['batches'])}; lite FENs equal full; found, FENs and boards equal the "
        f"plain-K1 path's at every size and batch")

    # times
    rec["times"] = {
        "process_image_12MP_ms": profiling.wall_ms(lambda: cv.process_image(frames["12MP"][0]), iters=7),
        "process_image_48MP_ms": profiling.wall_ms(lambda: cv.process_image(frames["48MP"][0]), iters=5),
        "process_batch_12MP_B4_ms": profiling.wall_ms(lambda: engine.process_batch(batch12), iters=3),
        "upload_12MP_ms": profiling.wall_ms(lambda: torch.from_numpy(frames["12MP"]).cuda(), iters=5),
        "upload_48MP_ms": profiling.wall_ms(lambda: torch.from_numpy(frames["48MP"]).cuda(), iters=5),
    }
    p50 = {k: percentile(v, 0.5) for k, v in rec["times"].items()}
    rec["p50"] = p50
    log(f"[photos] p50 ms: {json.dumps(p50)} (first calls at each size: "
        f"{json.dumps({k: round(v, 1) for k, v in cold.items()})})")
    rec["stages"] = {}
    for name in ("12MP", "48MP"):
        stages, total = profiling.stage_breakdown(engine, frames[name], iters=3)
        rec["stages"][name] = {"total_ms": total, **stages}
        log(f"[photos] stages of process_batch B=1 {name}, {total:.2f} ms (stages synchronized): "
            + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    rec["k1"] = {}
    for name in PHOTO_SIZES:
        imgs, minv, out_h, out_w = k1_args[f"process_image {name}"]
        t = time_k1(k1, imgs, minv, out_h, out_w, plain_iters=1)
        t["fused_plain_max_abs_err"] = max_err(k1.warp_fused(imgs, minv, out_h, out_w),
                                               k1.warp_fused_plain(imgs, minv, out_h, out_w))
        rows, smem = k1.pass1_plan(imgs.shape[2])
        mid = 4 * imgs.shape[0] * imgs.shape[1] * out_w
        t["pass1_plan"] = [rows, smem]
        # the design's bytes: pass 1 reads every source row whole and writes the intermediate
        t["pass1_bound_ms"] = (4 * imgs.numel() + mid) / HBM_BYTES_PER_S * 1e3
        t["pass2_bound_ms"] = (mid + 4 * imgs.shape[0] * out_h * out_w) / HBM_BYTES_PER_S * 1e3
        rec["k1"][name] = t
        log(f"[photos] K1 {name} {list(imgs.shape)} -> {out_h}x{out_w}, pass 1 plan {rows} rows / {smem} B: "
            f"{t['ms']:.3f} ms (pass 1 {t['pass1_ms']:.3f} against the design's {t['pass1_bound_ms']:.3f}, pass 2 "
            f"{t['pass2_ms']:.3f} against {t['pass2_bound_ms']:.3f}); function's floor {t['bound_ms']:.4f} (taps "
            f"touch {t['tap_bytes'] / 1e6:.2f} MB, {100 * t['source_share']:.1f}% of the frame), "
            f"grid_sample twice {t['library_ms']:.3f}, plain {t['plain_ms']:.1f}")
        log(f"[photos] K1 {name} routes: warp_plan picks {t['route']}; fused {t['fused_ms']:.4f} ms (cold "
            f"{t['fused_cold_ms']:.4f}) against two-pass {t['twopass_ms']:.4f} (cold {t['twopass_cold_ms']:.4f}): "
            f"{t['twopass_cold_ms'] / t['fused_cold_ms']:.2f}x cold; grid_sample twice {t['library_ms']:.4f} (cold "
            f"{t['library_cold_ms']:.4f}: {t['library_cold_ms'] / t['fused_cold_ms']:.2f}x the fused kernel); "
            f"function's floor {t['bound_ms']:.4f}; "
            f"routes differ by {t['routes_max_abs_diff']}, fused kernel against warp_fused_plain by "
            f"{t['fused_plain_max_abs_err']} (plain {t['fused_plain_ms']:.2f} ms)")
        if t["routes_max_abs_diff"] or t["fused_plain_max_abs_err"]:
            fail(f"photos: K1 {name}: the routes or the fused kernel and its plain version differ")
    del k1_args
    log(f"[photos] routes of the pipeline calls: {json.dumps(rec['routes'])}; launches by kernel "
        f"{json.dumps(rec['launches_by_kernel'])}")
    rec["max_abs_err"] = max(e for case in rec["errors"].values() for e in case.values())
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[photos] K1 launches {launches}, max |kernel - plain| {rec['max_abs_err']}; phase {rec['seconds']:.1f} s")
    return launches, rec


# the variables the port's engine and roots read; phase 18's children get
# exactly one of them each
EDGE_VARS = ("CVTPU_ROOT", "CVTPU_DATA_ROOT", "CVTPU_REFINE", "CVTPU_REFINE_MARGIN", "CVTPU_ARBITRATE_CHUNK")
# what the JAX package returns at B=0 (its CPU run): field -> (shape, dtype)
EMPTY_FULL = {
    "logits": ((0, 256, 256), "float32"), "binary_mask": ((0, 256, 256), "uint8"),
    "quadrangle": ((0, 4, 2), "float32"), "board_found": ((0,), "bool"),
    "board_image": ((0, 512, 512), "uint8"), "probabilities": ((0, 64, 13), "float32"),
}
EMPTY_LITE = {**EMPTY_FULL, "logits": ((0, 0, 0), "float32"), "binary_mask": ((0, 0, 0), "uint8"),
              "board_image": ((0, 0, 0), "uint8")}
EMPTY_DEVICE = {"logits": ((0, 256, 256), "float32"), "quadrangle": ((0, 4, 2), "float32"),
                "found": ((0,), "bool"), "board_image": ((0, 512, 512), "uint8"),
                "probabilities": ((0, 64, 13), "float32")}


def layout(fields: dict) -> dict:
    """{name: (shape, dtype name)} of arrays or tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in fields.items()}


def edges_child(out_path: str, seed: int) -> int:
    """One child of phase 18, in the environment its parent gave it:
    ``ChessVision()`` as a user builds it, one ``process_batch`` of
    ``board_frames(seed, 8)`` with K1 counted from 0 and captured, the
    captured call held against the plain version; writes its record."""
    import torch

    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.ops import hat_resample as k1
    from chessvision_tpu_torch.synthetic import board_frames

    frames8, _ = board_frames(seed, 8)
    cv = ChessVision()
    engine = cv.engine
    k1.launches = 0
    res, calls = capture_k1(k1, lambda: engine.process_batch(frames8))
    torch.cuda.synchronize()
    launches = k1.launches
    errs = check_captured(k1, calls, "edges child")
    imgs, _, out_h, out_w = calls["warp_twopass"][0]
    rec = {
        "env": {v: os.environ[v] for v in EDGE_VARS if v in os.environ},
        "repo_root": str(constants.REPO_ROOT),
        "weights": [cv._board_extractor_weights, cv._classifier_weights],
        "refine": engine._refine, "margin": engine_mod._REFINE_MARGIN, "canvas": [out_h, out_w],
        "warp_batch": imgs.shape[0], "launches": launches,
        "max_abs_err": max(e for case in errs.values() for e in case.values()),
        "found": res.board_found.tolist(), "fens": res.fens,
    }
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def phase_edges(k1, cv, seed: int, root: str) -> tuple[int, dict]:
    """Phase 18: the port's last parity repairs on the card.  (a) B=0
    through ``process_batch`` (full and lite), ``run_device`` on the card
    and the raw ``run_stream``: the JAX package's fields, shapes and dtypes,
    ``warp_twopass`` called and K1 launched no time (its launchers' own
    guard); (b) three children, started at once, each in an environment
    with one variable set: ``CVTPU_REFINE=detect``, ``CVTPU_REFINE_MARGIN=0``
    and ``CVTPU_ROOT`` at a directory holding a copy of ``weights/``; each
    child's found flags and FENs equal this process's on the same frames
    given ``refine_grid="detect"``, a 512² canvas (the module's margin set
    to 0) and the checkout's weights; every pipeline call 2 K1 launches,
    held against the plain version.  Returns K1's launches over the
    pipeline calls (the children's included) and the phase's record."""
    import numpy as np
    import torch

    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import board_frames

    t_phase = time.perf_counter()
    engine = cv.engine
    rec = {"errors": {}, "children": {}}

    # (b) first, so that the children reach the card while (a) runs
    weights_root = os.path.join(root, "relocated")
    shutil.copytree(constants.WEIGHTS_DIR, os.path.join(weights_root, "weights"))
    envs = {"detect": {"CVTPU_REFINE": "detect"}, "margin0": {"CVTPU_REFINE_MARGIN": "0"},
            "root": {"CVTPU_ROOT": weights_root}}
    base = {k: v for k, v in child_env().items() if k not in EDGE_VARS}
    procs = {}
    for name, extra in envs.items():
        out = os.path.join(root, f"edges-{name}.json")
        procs[name] = (out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--edges-child", out, str(seed)], env={**base, **extra},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # (a) an empty batch
        frames0 = np.zeros((0, 512, 512, 3), np.uint8)
        k1.launches = 0
        full, calls0 = capture_k1(k1, lambda: engine.process_batch(frames0))
        lite = engine.process_batch(frames0, lite=True)
        dev = engine.run_device(torch.zeros((0, 512, 512, 3), dtype=torch.uint8, device=engine.device))
        streamed = list(engine.run_stream([frames0], kind="raw"))
        torch.cuda.synchronize()
        launches0 = k1.launches
        got = {
            "process_batch": layout({k: getattr(full, k) for k in EMPTY_FULL}),
            "process_batch lite": layout({k: getattr(lite, k) for k in EMPTY_LITE}),
            "run_device": layout(dev),
            "run_stream": [layout(o) for o in streamed],
        }
        want = {"process_batch": EMPTY_FULL, "process_batch lite": EMPTY_LITE, "run_device": EMPTY_DEVICE,
                "run_stream": [EMPTY_DEVICE]}
        problems = [k for k in want if got[k] != want[k]]
        if full.fens or lite.fens or not all(t.is_cuda for t in [*dev.values(), *streamed[0].values()]):
            problems.append("FENs of no frames, or outputs off the card")
        warp0 = [tuple(a[0].shape) for a in calls0["warp_twopass"]]
        log(f"[edges] B=0: {json.dumps(got)}; warp_twopass called on {warp0}; K1 launches {launches0}")
        if problems or launches0 != 0 or warp0 != [(0, 512, 512)]:
            fail(f"edges: B=0 gives {problems} against the JAX package's layout, K1 launches {launches0} "
                 f"(expected 0), warp_twopass calls {warp0}")
        rec["b0"] = {"layouts": got, "launches": launches0, "warp_calls": warp0}

        # this process's side of (b): the same frames, the choice made explicitly
        frames8, _ = board_frames(seed, 8)
        launches = 0

        def pipeline(label: str, fn):
            nonlocal launches
            k1.launches = 0
            res, calls = capture_k1(k1, fn)
            torch.cuda.synchronize()
            if k1.launches != 2 or len(calls["warp_twopass"]) != 1:
                fail(f"edges: {label}: expected 2 K1 launches, got {k1.launches}")
            launches += k1.launches
            rec["errors"].update(check_captured(k1, calls, f"edges {label}"))
            return res, calls["warp_twopass"][0]

        refs = {"root": pipeline("checkout", lambda: engine.process_batch(frames8))[0]}
        refs["detect"] = pipeline("refine_grid=detect", lambda: ChessVision(refine_grid="detect").engine
                                  .process_batch(frames8))[0]
        margin, engine_mod._REFINE_MARGIN = engine_mod._REFINE_MARGIN, 0
        try:
            refs["margin0"], args = pipeline("margin 0", lambda: engine.process_batch(frames8))
        finally:
            engine_mod._REFINE_MARGIN = margin
        if args[2:] != (512, 512):
            fail(f"edges: margin 0 warped into {args[2:]}, not 512²")

        outs = {}
        for name, (_, proc) in procs.items():
            outs[name] = proc.communicate(timeout=300)[0]
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want_child = {"detect": ("detect", 32, [576, 576]), "margin0": ("arbitrate", 0, [512, 512]),
                  "root": ("arbitrate", 32, [576, 576])}
    for name, (out, proc) in procs.items():
        if proc.returncode != 0:
            fail(f"edges: child {name} exited {proc.returncode}:\n{outs[name][-4000:]}")
        with open(out) as f:
            child = json.load(f)
        rec["children"][name] = child
        ref = refs[name]
        problems = []
        if (child["refine"], child["margin"], child["canvas"]) != want_child[name]:
            problems.append(f"mode {child['refine']}, margin {child['margin']}, canvas {child['canvas']}")
        if child["found"] != ref.board_found.tolist() or child["fens"] != ref.fens:
            problems.append(f"found/FENs {child['found']} {child['fens']} vs {ref.board_found.tolist()} {ref.fens}")
        if child["launches"] != 2 or not child["max_abs_err"] <= K1_TOL:
            problems.append(f"K1 launches {child['launches']}, max |kernel - plain| {child['max_abs_err']}")
        if name == "root" and not (child["repo_root"] == weights_root and all(
                w.startswith(weights_root + os.sep) and os.path.exists(w) for w in child["weights"])):
            problems.append(f"root {child['repo_root']}, weights {child['weights']}")
        log(f"[edges] child {json.dumps(child['env'])}: refine {child['refine']}, margin {child['margin']}, "
            f"canvas {child['canvas']}, K1 launches {child['launches']}, max |kernel - plain| "
            f"{child['max_abs_err']}, found {sum(child['found'])}/8, FENs equal this process's "
            f"{child['fens'] == ref.fens}, weights {child['weights']}")
        if problems:
            fail(f"edges: child {name}: {problems}")
        launches += child["launches"]
    rec["max_abs_err"] = max([e for case in rec["errors"].values() for e in case.values()]
                             + [c["max_abs_err"] for c in rec["children"].values()])
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[edges] K1 launches {launches} (B=0: {launches0}), max |kernel - plain| {rec['max_abs_err']}; "
        f"phase {rec['seconds']:.1f} s")
    return launches, rec


BENCH_KEYS = ("metric", "value", "unit", "paths_boards_per_sec", "paths_kb_per_board", "e2e_mode",
              "stream_batches_per_cycle", "serialized_yuv444_boards_per_sec", "compute_boards_per_sec",
              "compute_batch_size_attempted", "compute_batch_size", "compute_mfu", "pipeline_gflop_per_board",
              "pipeline_gflop_per_board_in_bounds", "link_mb_per_sec_before_e2e",
              "link_mb_per_sec_after_e2e", "p50_latency_ms", "p50_latency_lite_ms", "batch_size",
              "boards_found_last_batch", "fens_sha256", "backend", "device", "power_limit_w")
STAGE_KEYS = ("resize_512_256", "grayscale", "unet_fwd", "quadrangle", "homography_warp", "squares_classifier",
              "fused_total", "batch_size", "backend", "device", "power_limit_w")
TRAIN_KEYS = ("trainer", "batch_size", "image_size", "step_ms", "images_per_sec", "steps_per_epoch",
              "epoch_s_projected", "backend", "device", "power_limit_w")
SWEEP_KEYS = ("batch", "chunk", "refine", "compile_plus_first_s", "boards_per_sec", "ms_per_batch", "boards_found",
              "fens_sha256", "peak_memory_gb", "backend", "device", "power_limit_w")
MICRO_KEYS = ("warp_twopass_ms", "warp_twopass_plain_ms", "grid_sample_twice_ms", "warp_max_abs_err",
              "warp_bound_ms", "smooth_9x9_2d", "smooth_9x9_sep", "flood_halfres", "support_decimate",
              "route_sweep", "route_rule", "backend", "device", "power_limit_w")


def phase_measure(k1, cv, card: str) -> tuple[int, dict]:
    """Phase 19: the port's measuring tools, each one's ``main()`` in this
    process at its defaults on the card, its printed lines caught, K1
    counted and the first call of each shape it hands K1 recorded:
    ``bench_torch.py`` (B=128, iters 6), ``profile_stages`` (B=128),
    ``bench_training`` (both trainers), ``sweep_arbitrate_chunk`` at chunks
    128 and 512 (B=1024), ``microbench --which all`` and ``mfu_accounting``
    on the times those printed.  Each must print its JSON line(s) with
    its keys and the card's name and power limit; the bench's last FENs
    equal ``process_batch``'s on its frames and found boards; the sweep's
    FENs are equal across chunks; microbench's K1 error is 0; every
    recorded K1 call is held against its plain version.  Returns K1's
    launches inside the tools and the tools' records."""
    import io

    import torch

    from chessvision_tpu_torch.tools import (
        bench,
        bench_training,
        mfu_accounting,
        microbench,
        profile_stages,
        sweep_arbitrate_chunk,
    )

    t_phase = time.perf_counter()
    smi_name, _, smi_limit = card.rpartition(",")
    try:
        limit = float(smi_limit.split()[0])
    except (ValueError, IndexError):
        limit = None
    seen: set = set()
    res: dict = {"errors": {}, "seconds": {}, "launches": {}}

    def call(tool: str, main, argv: list[str], n_lines: int, keys: tuple) -> list[dict]:
        t0 = time.perf_counter()
        buf = io.StringIO()
        k1.launches = 0
        with contextlib.redirect_stdout(buf):
            rc, calls = capture_k1(k1, lambda: main(argv), seen)
        torch.cuda.synchronize()
        launched = k1.launches
        res["launches"][tool] = res["launches"].get(tool, 0) + launched
        res["seconds"][tool] = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"[measure] {tool}: {line}")
        recs = [json.loads(line) for line in lines if line.startswith("{")]
        if rc != 0 or len(recs) != n_lines:
            fail(f"measure: {tool} {argv} returned {rc} with {len(recs)} JSON lines, expected {n_lines}")
        for rec in recs:
            missing = [k for k in keys if k not in rec]
            if missing or rec["device"] != smi_name.strip() or rec["power_limit_w"] != limit:
                fail(f"measure: {tool} line lacks {missing} or names another card than {card!r}: {rec}")
        if calls["warp_twopass"] or calls["hat_resample"]:
            res["errors"].update(check_captured(k1, calls, f"measure {tool}"))
        log(f"[measure] {tool} {' '.join(argv)}: {res['seconds'][tool]:.1f} s, K1 launches {launched}")
        return recs

    (rec,) = call("bench_torch", bench.main, [], 1, BENCH_KEYS)
    frames, _ = bench.bench_frames(rec["batch_size"], 0)
    want = cv.engine.process_batch(frames)
    if rec["boards_found_last_batch"] <= 0 or rec["fens_sha256"] != bench.fens_digest(want.fens):
        fail(f"measure: the bench's last FENs ({rec['boards_found_last_batch']} found) differ from "
             f"process_batch's on its frames ({int(want.board_found.sum())} found)")
    res["bench"] = rec
    (res["profile_stages"],) = call("profile_stages", profile_stages.main, ["--batch-size", "128"], 1, STAGE_KEYS)
    unet, cls = call("bench_training", bench_training.main, [], 2, TRAIN_KEYS)
    res["bench_training"] = [unet, cls]
    # at the default B=1024, which phase 20 (b) holds to run without an error
    sweeps = [call("sweep_arbitrate_chunk", sweep_arbitrate_chunk.main, ["--chunk", str(c)], 1,
                   SWEEP_KEYS)[0] for c in (128, 512)]
    if len({(s["boards_found"], s["fens_sha256"]) for s in sweeps}) != 1 or not sweeps[0]["boards_found"]:
        fail(f"measure: the sweep's found boards and FENs differ across chunks: {sweeps}")
    res["sweep"] = sweeps
    (res["microbench"],) = call("microbench", microbench.main, ["--which", "all"], 1, MICRO_KEYS)
    if res["microbench"]["warp_max_abs_err"] != 0.0:
        fail(f"measure: microbench's K1 differs from its plain version by {res['microbench']['warp_max_abs_err']}")
    sweep = res["microbench"]["route_sweep"]
    log(f"[measure] K1 route sweep ({res['microbench']['route_rule']}; ms, warm / cold): " + "; ".join(
        f"{r['shape'][:3]} fused {r['fused_ms']:.4f} / {r['fused_cold_ms']:.4f}, two-pass {r['twopass_ms']:.4f} / "
        f"{r['twopass_cold_ms']:.4f}, picks {r['route']}" for r in sweep))
    if any(r["routes_max_abs_diff"] != 0.0 for r in sweep):
        fail(f"measure: K1's two routes differ in the sweep: {sweep}")
    (res["mfu"],) = call("mfu_accounting", mfu_accounting.main,
                         ["--unet-step-ms", str(unet["step_ms"]), "--cls-step-ms", str(cls["step_ms"]),
                          "--compute-boards-per-sec", str(rec["compute_boards_per_sec"]),
                          "--warp-ms-128", str(res["microbench"]["warp_twopass_ms"])], 1,
                         ("rows", "forward_gflop", "xla_gflop", "flop_count", "device", "power_limit_w"))
    idle = [t for t in ("bench_torch", "profile_stages", "bench_training", "microbench") if not res["launches"][t]]
    if idle:
        fail(f"measure: K1 never launched inside {idle}")
    res["max_abs_err"] = max((e for case in res["errors"].values() for e in case.values()), default=0.0)
    launches = sum(res["launches"].values())
    res["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"[measure] K1 launches {launches} in the tools {res['launches']}, {len(res['errors'])} recorded calls held against the plain "
        f"version, max |kernel - plain| {res['max_abs_err']}; phase {res['seconds']['phase']:.1f} s")
    return launches, res


LOADTEST_KEYS = ("mode", "requests", "concurrency", "req_per_sec", "p50_ms", "p95_ms", "wall_s", "image", "fen",
                 "device", "power_limit_w")


def phase_memory(k1, cv, card: str, seed: int, sweeps: list[dict]) -> tuple[int, dict]:
    """Phase 20, after phase 19's bench streams in this process: (a)
    ``run_device`` at B=1024 (``tools/memory_peaks``: the peak through the
    UNet and after the tail) with ``found`` flags and FENs equal to two
    B=512 calls, each peak printed, then B=128 for the table; (b) phase
    19's sweep at the default B=1024, chunks 128 and 512, ran without an
    error; (c) ``tools/loadtest_server`` at 32 requests, 1 and then 16 at a
    time (the tool holds every served FEN to ``process_batch``'s); (d)
    ``tools/make_hard_example_weights`` on a seeded synthetic squares root,
    then one ``train_classifier`` epoch with ``use_sample_weights`` that
    must read the column it wrote.  Returns K1's launches and the records."""
    import io

    import numpy as np
    import torch

    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.synthetic import board_frames, write_squares_dataset
    from chessvision_tpu_torch.tools import loadtest_server, make_hard_example_weights, memory_peaks
    from chessvision_tpu_torch.train import tables, train_classifier

    t_phase = time.perf_counter()
    res: dict = {"seconds": {}}
    launches = 0
    engine = cv.engine

    # (a) B=1024 against two B=512 calls
    k1.launches = 0
    frames = torch.from_numpy(board_frames(seed, 32)[0]).cuda()
    rec1024, out1024 = memory_peaks.peaks(engine, frames, 1024)
    log(f"[memory] {card}: run_device B=1024 after the bench's streams: {json.dumps(rec1024)}")
    if out1024 is None:
        fail(f"memory: run_device at B=1024 ran out of memory: {rec1024}")
    halves = []
    for i in range(2):
        rec, out = memory_peaks.peaks(engine, frames, 512)
        log(f"[memory] {card}: run_device B=512 ({'first' if i == 0 else 'second'} half): {json.dumps(rec)}")
        if out is None:
            fail(f"memory: run_device at B=512 ran out of memory: {rec}")
        halves.append((rec, out))
    found1024 = out1024["found"].cpu().numpy()
    found512 = np.concatenate([out["found"].cpu().numpy() for _, out in halves])
    fens1024 = fens_of(engine_mod, constants, out1024)
    fens512 = [f for _, out in halves for f in fens_of(engine_mod, constants, out)]
    if not ((found1024 == found512).all() and fens1024 == fens512 and found1024.any()):
        fail(f"memory: B=1024 gives other found flags or FENs than two B=512 calls "
             f"({int(found1024.sum())} / {int(found512.sum())} found)")
    del out1024, halves
    rec128, out128 = memory_peaks.peaks(engine, frames, 128)
    log(f"[memory] {card}: run_device B=128: {json.dumps(rec128)}")
    torch.cuda.synchronize()
    launches += k1.launches
    res["peaks"] = {"1024": rec1024, "512": rec, "128": rec128}
    res["found_1024"] = int(found1024.sum())
    del out128
    res["seconds"]["a"] = time.perf_counter() - t_phase

    # (b) the sweep at B=1024 (phase 19)
    bad = [s for s in sweeps if s["batch"] != 1024 or "error" in s]
    if bad:
        fail(f"memory: the sweep did not run at B=1024 without an error: {bad}")
    res["sweep_peaks_gb"] = [s["peak_memory_gb"] for s in sweeps]
    log(f"[memory] sweep at B=1024, chunks 128 and 512: {[s['boards_per_sec'] for s in sweeps]} boards/s, "
        f"peaks {res['sweep_peaks_gb']} GB, no error")

    # (c) the load test, one request at a time and 16 at once
    t0 = time.perf_counter()
    res["loadtest"] = []
    for conc in (1, 16):
        buf = io.StringIO()
        k1.launches = 0
        with contextlib.redirect_stdout(buf):
            rc = loadtest_server.main(["--requests", "32", "--concurrency", str(conc)])
        torch.cuda.synchronize()
        launches += k1.launches
        recs = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
        if rc != 0 or len(recs) != 1 or any(k not in recs[0] for k in LOADTEST_KEYS) or not recs[0]["fen"]:
            fail(f"memory: loadtest_server --concurrency {conc} returned {rc}: {buf.getvalue()[-2000:]}")
        log(f"[memory] loadtest_server: {json.dumps(recs[0])}")
        res["loadtest"].append(recs[0])
    res["seconds"]["c"] = time.perf_counter() - t0

    # (d) hard-example weights, then an epoch that reads them
    t0 = time.perf_counter()
    saved_env = {k: os.environ.get(k) for k in ("CVTPU_DATA_ROOT", "CVTPU_STORE_ROOT")}
    read: list = []
    real_read = tables.sample_weights_for_ids

    def reading(table, ids):
        w = real_read(table, ids)
        read.append(w)
        return w

    with tempfile.TemporaryDirectory(prefix="chip-smoke-weights-") as root:
        data_root = os.path.join(root, "data")
        os.environ["CVTPU_DATA_ROOT"] = data_root
        os.environ["CVTPU_STORE_ROOT"] = os.path.join(root, "store")
        tables.sample_weights_for_ids = reading
        try:
            write_squares_dataset(data_root, 40, 10, seed)
            buf = io.StringIO()
            k1.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = make_hard_example_weights.main(["--data-root", data_root])
            lines = buf.getvalue().splitlines()
            for line in lines:
                log(f"[memory] make_hard_example_weights: {line}")
            if rc != 0 or not lines or not lines[0].startswith("wrote sample_weight to "):
                fail(f"memory: make_hard_example_weights returned {rc}: {lines}")
            column = tables.get_or_create_classification_tables()["train"]["sample_weight"]
            run, _ = train_classifier.train_model(run_name="smoke-hard-weights", model_dtype=torch.bfloat16,
                                                  device="cuda", seed=seed, epochs=1, batch_size=256, width=64,
                                                  augment=True, use_sample_weights=True)
            torch.cuda.synchronize()
            launches += k1.launches
            losses = [s["train_loss"] for s in run.scalars() if "train_loss" in s]  # read before the store goes
        finally:
            tables.sample_weights_for_ids = real_read
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if len(read) != 1 or read[0] is None or not np.allclose(np.sort(read[0]), np.sort(column)):
        fail(f"memory: the --use-sample-weights epoch did not read the written column ({len(read)} reads)")
    if len(losses) != 1 or not np.isfinite(losses).all():
        fail(f"memory: the weighted epoch's loss is not finite: {losses}")
    res["hard_weights"] = {"line": lines[0], "weights_min": float(column.min()), "weights_max": float(column.max()),
                           "epoch_loss": losses[0]}
    res["seconds"]["d"] = time.perf_counter() - t0
    res["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"[memory] the weighted epoch read {len(read[0])} weights in [{read[0].min():.3f}, {read[0].max():.3f}], "
        f"loss {losses[0]:.4f}; phase {res['seconds']['phase']:.1f} s, K1 launches {launches}")
    return launches, res


# -- 21. the test-set tools -------------------------------------------------------------------------

# the seeded test set: sizes taken in turn, so frames 8 and 17 are 768² and the other 16 are 512²
# (two shape groups; 768² takes K1's two-pass route into the 576² canvas and the fused route
# into exp_gridfix_quad's 512² board)
TESTSET_N = 18
TESTSET_SIZES = (512,) * 8 + (768,)
# the band the phase holds the card's FENs to on that set, calibrated as the JAX gate was
# (scripts/tpu_drift_gate.py: 37/38 exact and 2 squares measured, floor 35 and band 3): on an
# H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6) 16 of 18 boards were exact and the
# worst 2 squares off, so one square of headroom on the worst board and two boards on the floor
GATE_MAX_SQUARE_DIFF = 3
GATE_MIN_EXACT = 14


def moved_fen(fen: str, k: int) -> str:
    """``fen`` with its first ``k`` squares (FEN order) changed."""
    from chessvision_tpu_torch.chessboard import fen_to_labels

    labels = fen_to_labels(fen)
    for i in range(k):
        labels[i] = "q" if labels[i] != "q" else "Q"
    rows = []
    for r in range(8):
        row, empty = "", 0
        for lab in labels[8 * r : 8 * r + 8]:
            if lab == "f":
                empty += 1
                continue
            row += (str(empty) if empty else "") + lab
            empty = 0
        rows.append(row + (str(empty) if empty else ""))
    return "/".join(rows)


def phase_testset(k1, cv, seed: int, root: str, card: str) -> tuple[int, dict]:
    """Phase 21: the four programs that read the test set, on a seeded
    synthetic one (``write_test_root``: 16 frames at 512², 2 at 768²).
    (b) ``tools/make_fen_goldens`` on the CPU; (c) ``tools/drift_gate`` on
    the card against them: found flags identical, exact boards and the
    worst board's difference within ``GATE_*``; (d) the gate against two
    altered copies (a board's FEN moved by the band + 1 squares, a found
    flag flipped) fails with the script's failure string; (e)
    ``debug_gridfix`` per image and ``--summary`` on the card and on the
    CPU: the boards whose chosen side or candidate FENs differ between the
    two, the largest correction and gap differences, and each device's
    ``fen_blend_0.01`` against its own ``process_batch`` FEN; (f)
    ``exp_gridfix_quad`` on the card; (g) every K1 call of (c)–(f) held
    against its plain version, and K1 at 512²→512² timed.  Returns K1's
    launches over (c)–(f) and the phase's record."""
    import contextlib
    import io

    import torch

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval.evaluate import get_test_generator
    from chessvision_tpu_torch.synthetic import write_test_root
    from chessvision_tpu_torch.tools import debug_gridfix, drift_gate, exp_gridfix_quad, make_fen_goldens

    t_phase = time.perf_counter()
    dev_type = cv.engine.device.type
    test_root = str(write_test_root(os.path.join(root, "testset"), TESTSET_N, seed + 21, TESTSET_SIZES))
    items = list(get_test_generator(test_root))
    shapes = sorted({tuple(it[0].shape[:2]) for it in items})
    rec: dict = {"images": len(items), "shapes": shapes, "seconds": {}}
    if len(items) != TESTSET_N or len(shapes) != 2:
        fail(f"testset: expected {TESTSET_N} frames in two shapes, read {len(items)} in {shapes}")

    def printed(fn, *args) -> list[dict]:
        """``fn(*args)``'s printed JSON lines (it must return 0 or None)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(*args)
        if rc not in (0, None):
            fail(f"testset: {fn.__module__}.main{args} returned {rc}")
        return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]

    # (b) the CPU goldens: the tool's command line in a process of its own, while this process
    # replays debug_gridfix on the CPU and runs the card's programs that need no goldens (each
    # side takes half the CPU's threads: the plain warp gains little past four)
    goldens_path = os.path.join(root, "testset_goldens_cpu.json")
    goldens_log = os.path.join(root, "testset_goldens_cpu.log")
    threads = max(1, (os.cpu_count() or 2) // 2)
    t_goldens = time.perf_counter()
    with open(goldens_log, "w") as out:
        child = subprocess.Popen(
            [sys.executable, "-m", "chessvision_tpu_torch.tools.make_fen_goldens", "--test-root", test_root,
             "--out", goldens_path],
            env={**child_env(), "OMP_NUM_THREADS": str(threads)}, stdout=out, stderr=subprocess.STDOUT)
    try:
        # (e) debug_gridfix on the CPU (the tool's functions: one replay gives both of its outputs)
        t0 = time.perf_counter()
        saved_threads = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            cpu_engine = ChessVision(lazy_load=False, device="cpu").engine
            per_item_cpu = debug_gridfix.replay_items(cpu_engine, items)
        finally:
            torch.set_num_threads(saved_threads)
        per_cpu = debug_gridfix.records(per_item_cpu, items, "cpu")
        summary_cpu, dump_cpu = debug_gridfix.summarize(per_item_cpu, items, "cpu")
        rec["seconds"]["debug_gridfix_cpu"] = time.perf_counter() - t0

        # (c)–(f) on the card, every K1 call recorded
        dump_card = os.path.join(root, "debug_dump_card.json")

        def on_card():
            # (e) debug_gridfix on the card, per image and --summary (its dump: CVTPU_DEBUG_DUMP)
            t0 = time.perf_counter()
            per_image = printed(debug_gridfix.main, ["--test-root", test_root])
            saved = os.environ.get("CVTPU_DEBUG_DUMP")
            os.environ["CVTPU_DEBUG_DUMP"] = dump_card
            try:
                (debug_summary,) = printed(debug_gridfix.main, ["--summary", "--test-root", test_root])
            finally:
                if saved is None:
                    os.environ.pop("CVTPU_DEBUG_DUMP")
                else:
                    os.environ["CVTPU_DEBUG_DUMP"] = saved
            rec["seconds"]["debug_gridfix_card"] = time.perf_counter() - t0
            # (f) exp_gridfix_quad on the card
            t0 = time.perf_counter()
            quad_lines = printed(exp_gridfix_quad.main, ["--test-root", test_root])
            rec["seconds"]["exp_gridfix_quad"] = time.perf_counter() - t0
            # (c) the gate, once the goldens are written
            rc = child.wait(timeout=900)
            rec["seconds"]["goldens_cpu"] = time.perf_counter() - t_goldens
            if rc != 0:
                fail(f"testset: make_fen_goldens exited {rc}: {open(goldens_log).read()[-2000:]}")
            t0 = time.perf_counter()
            summary, got = drift_gate.gate(goldens_path, test_root, GATE_MAX_SQUARE_DIFF, GATE_MIN_EXACT, cv=cv)
            rec["seconds"]["gate"] = time.perf_counter() - t0
            goldens = json.loads(open(goldens_path).read())["results"]
            # (d) the gate must gate: two altered copies of the goldens
            exact_found = next((n for n, g in goldens.items() if g["found"] and got[n] == g), None)
            if exact_found is None:
                fail("testset: no found board with the golden's FEN to alter")
            first = next(iter(goldens))
            k = GATE_MAX_SQUARE_DIFF + 1
            moved = moved_fen(goldens[exact_found]["fen"], k)
            altered = {
                "moved": ({**goldens, exact_found: {"found": True, "fen": moved}},
                          f"{exact_found}: {k} squares differ from the CPU golden (band is {GATE_MAX_SQUARE_DIFF}): "
                          f"{dev_type}={got[exact_found]['fen']} golden={moved}"),
                "flipped": ({**goldens, first: {**goldens[first], "found": not goldens[first]["found"]}},
                            f"{first}: found flag drifted ({dev_type}={got[first]['found']}, "
                            f"golden={not goldens[first]['found']})"),
            }
            refused = {}
            for label, (alt, expected) in altered.items():
                path = os.path.join(root, f"testset_goldens_{label}.json")
                with open(path, "w") as f:
                    json.dump({"platform": "cpu", "results": alt}, f, indent=1, sort_keys=True)
                alt_summary, _ = drift_gate.gate(path, test_root, GATE_MAX_SQUARE_DIFF, GATE_MIN_EXACT, cv=cv)
                refused[label] = alt_summary["failures"]
                if expected not in alt_summary["failures"]:
                    fail(f"testset: the gate against the {label} goldens did not fail with {expected!r}: "
                         f"{alt_summary}")
            torch.cuda.synchronize()
            return goldens, summary, got, refused, per_image, debug_summary, quad_lines

        k1.zero_launches()
        (goldens, summary, got, refused, per_card, summary_card, quad_lines), calls = capture_k1(k1, on_card)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    launches = k1.launches
    rec["launches_by_kernel"] = dict(k1.kernel_launches)
    if sorted(goldens) != sorted(it[1] for it in items):
        fail(f"testset: the goldens name other images than the test set's: {sorted(goldens)}")
    log(f"[testset] CPU goldens of {len(items)} frames {shapes} (make_fen_goldens, {threads} threads, beside the "
        f"CPU replay) in {rec['seconds']['goldens_cpu']:.1f} s: {sum(g['found'] for g in goldens.values())} found")
    rec["gate"] = summary
    rec["refused"] = refused
    log(f"[testset] gate on the card ({card}): {json.dumps(summary)} in {rec['seconds']['gate']:.1f} s")
    drifted = [f for f in summary["failures"] if "found flag drifted" in f]
    if drifted:
        fail(f"testset: found flags differ between the card and the CPU goldens: {drifted}")
    if summary["failures"]:
        fail(f"testset: the card's FENs left the band (worst {GATE_MAX_SQUARE_DIFF} squares, at least "
             f"{GATE_MIN_EXACT} exact): {summary['failures']}")
    log(f"[testset] the gate refuses both altered goldens: {json.dumps(refused)}")

    dump_card = json.loads(open(dump_card).read())
    if [r["image"] for r in per_card] != [r["image"] for r in per_cpu] or set(dump_card) != set(dump_cpu):
        fail("testset: debug_gridfix on the card and on the CPU replayed other images")
    flips = [{"image": c["image"], **{k: [c[k], p[k]] for k in ("chosen", "fen0", "fen1", "found") if c[k] != p[k]}}
             for c, p in zip(per_card, per_cpu) if any(c[k] != p[k] for k in ("chosen", "fen0", "fen1", "found"))]
    rec["debug_gridfix"] = {
        "boards_that_differ": flips,
        "max_abs_corr_diff": max(abs(a - b) for c, p in zip(per_card, per_cpu) for a, b in zip(c["corr"], p["corr"])),
        "max_abs_conf_diff": max(abs(c[k] - p[k]) for c, p in zip(per_card, per_cpu) for k in ("conf0", "conf1")),
        "max_abs_gap_diff": max(abs((c["conf1"] - c["conf0"]) - (p["conf1"] - p["conf0"]))
                                for c, p in zip(per_card, per_cpu)),
        "wrong_squares_card": summary_card["wrong_squares"],
        "wrong_squares_cpu": summary_cpu["wrong_squares"],
        "near_ties_card": summary_card["near_ties_with_consequence"],
        "near_ties_cpu": summary_cpu["near_ties_with_consequence"],
        # the shipping τ's blend against the engine's own FEN on the same device (found boards)
        "blend_not_process_batch_card": sorted(n for n, g in got.items() if g["found"]
                                               and dump_card[n]["fen_blend_0.01"] != g["fen"]),
        "blend_not_process_batch_cpu": sorted(n for n, g in goldens.items() if g["found"]
                                              and dump_cpu[n]["fen_blend_0.01"] != g["fen"]),
    }
    log(f"[testset] debug_gridfix card against CPU ({rec['seconds']['debug_gridfix_card']:.1f} s on the card, "
        f"{rec['seconds']['debug_gridfix_cpu']:.1f} s on the CPU): {json.dumps(rec['debug_gridfix'])}")
    for c, p in zip(per_card, per_cpu):
        log(f"[testset]   {c['image']}: card {json.dumps({k: c[k] for k in ('corr', 'conf0', 'conf1', 'chosen')})} "
            f"cpu {json.dumps({k: p[k] for k in ('corr', 'conf0', 'conf1', 'chosen')})}")
    if summary_card["images"] != len(items) or summary_cpu["images"] != len(items):
        fail("testset: debug_gridfix --summary counted other images than the test set's")

    # (f) exp_gridfix_quad's lines
    totals = quad_lines[-1]
    if totals.get("backend") != dev_type or "sum_affine" not in totals:
        fail(f"testset: exp_gridfix_quad's totals line is malformed: {totals}")
    rec["exp_gridfix_quad"] = totals
    log(f"[testset] exp_gridfix_quad on the card ({rec['seconds']['exp_gridfix_quad']:.1f} s): "
        f"{len(quad_lines) - 1} boards with errors; totals {json.dumps(totals)}")

    # (g) K1: every recorded call against its plain version, 512²→512² timed
    rec["errors"] = check_captured(k1, calls, "testset")
    rec["max_abs_err"] = max(e for case in rec["errors"].values() for e in case.values())
    idle = sorted({name for kernels in k1.ROUTE_KERNELS.values() for name in kernels
                   if not rec["launches_by_kernel"][name]})
    if idle:
        fail(f"testset: K1 kernels {idle} never launched in (c)-(f): {rec['launches_by_kernel']}")
    board = next((a for a in calls["warp_twopass"] if tuple(a[0].shape[1:]) == (512, 512) and a[2:] == (512, 512)),
                 None)
    if board is None:
        fail("testset: exp_gridfix_quad made no 512²→512² warp")
    t = time_k1(k1, *board, plain_iters=1)
    rec["k1_512_to_512"] = {k: t[k] for k in ("shape", "route", "ms", "pass1_ms", "pass2_ms", "bound_ms",
                                                "library_ms", "plain_ms", "twopass_cold_ms", "library_cold_ms")}
    log(f"[testset] K1 {t['shape']} ({t['route']}): {t['ms']:.4f} ms (cold {t['twopass_cold_ms']:.4f}; pass 1 "
        f"{t['pass1_ms']:.4f}, pass 2 {t['pass2_ms']:.4f}) against its bytes bound {t['bound_ms']:.4f} ms; "
        f"F.grid_sample twice {t['library_ms']:.4f} (cold {t['library_cold_ms']:.4f}); plain {t['plain_ms']:.1f}; {card}")
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"[testset] K1 launches {launches} {json.dumps(rec['launches_by_kernel'])} over {len(calls['warp_twopass'])} "
        f"calls, max |kernel - plain| {rec['max_abs_err']}; seconds {json.dumps(rec['seconds'])}")
    return launches, rec


# the layout of graft_entry_torch.entry()'s outputs at B frames, as tests/test_torch_graft_entry.py holds
# it against the JAX entry()'s on the CPU (keys, shapes, dtype names)
ENTRY_LAYOUT = {"logits": ((256, 256), "float32"), "quadrangle": ((4, 2), "float32"), "found": ((), "bool"),
                "board_image": ((512, 512), "uint8"), "probabilities": ((64, 13), "float32")}
DRYRUN_LINE = re.compile(
    r"^dryrun_multichip ok on (\d+) devices: seg loss (\S+), cls loss (\S+), engine batch \((\d+), 64, 13\)$")


@contextlib.contextmanager
def stdout_captured(into: list):
    """File descriptor 1 redirected to a temporary file inside the block
    (this process's prints and its children's alike); its text is appended
    to ``into`` and echoed after the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile(mode="w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            into.append(f.read())
            sys.stdout.write(into[-1])
            sys.stdout.flush()


def dryrun_problems(recs: list[dict], n: int, printed: str) -> list[str]:
    """What is wrong with a ``dryrun_multichip(n)`` run: its records (ranks
    0…n-1, the engine batch, finite losses equal on every rank) and what it
    printed (rank 0's line, once, in the JAX script's format)."""
    import math

    problems = []
    if [r["rank"] for r in recs] != list(range(n)) or any(r["engine_batch"] != [n, 64, 13] for r in recs):
        problems.append(f"records {[(r['rank'], r['engine_batch']) for r in recs]}")
    losses = {(r["seg_loss"], r["cls_loss"]) for r in recs}
    if len(losses) != 1 or not all(math.isfinite(x) for x in next(iter(losses))):
        problems.append(f"losses {sorted(losses)}")
    lines = [ln for ln in printed.splitlines() if ln.startswith("dryrun_multichip")]
    m = DRYRUN_LINE.match(lines[0]) if len(lines) == 1 else None
    if not (m and lines[0] == recs[0]["line"] and int(m.group(1)) == n and int(m.group(4)) == n):
        problems.append(f"printed {lines}")
    return problems


def tf32_threads(k1, seed: int) -> tuple[dict, dict]:
    """Two threads call ``process_batch`` at once on four 12 MP frames (two
    each, three times) with the caller's TF32 flags on: every call's
    ``comp`` (the front half's matmul resize) against one thread's in full
    float32 on the card, bit for bit, and the flags after; beside them, the
    pixels a TF32 resize moves and those where the card's full-float32
    ``comp`` differs from the CPU's.  Returns the record and what the
    calls handed K1 (one call a shape)."""
    import threading

    import torch

    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.synthetic import photo_frames
    from chessvision_tpu_torch.utils import full_f32

    frames = photo_frames(seed + 3, 4, *PHOTO_SIZES["12MP"])[0]
    xs = [torch.from_numpy(f[None]) for f in frames]
    cpu = [engine_mod.preprocess_images(x)[0] for x in xs]
    with torch.inference_mode(), full_f32():
        one = [engine_mod.preprocess_images(x.cuda())[0].cpu() for x in xs]
    engine = ChessVision(device="cuda").engine
    engine.process_batch(frames[:1])  # warm-up
    real = engine_mod.preprocess_images
    seen: list = []

    def recording(images):
        comp, gray = real(images)
        seen.append((images[0, ::97, ::89].cpu(), comp.cpu()))
        return comp, gray

    def work(rows, go, errors) -> None:
        try:
            go.wait(30)
            for _ in range(3):
                for i in rows:
                    engine.process_batch(frames[i:i + 1])
        except Exception as e:  # reported by the caller
            errors.append(repr(e))

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    errors: list = []
    go = threading.Barrier(2)
    try:
        with torch.inference_mode():
            tf32 = [real(x.cuda())[0].cpu() for x in xs]
        engine_mod.preprocess_images = recording
        threads = [threading.Thread(target=work, args=(rows, go, errors)) for rows in ((0, 1), (2, 3))]

        def run() -> bool:
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            return any(t.is_alive() for t in threads)

        alive, calls = capture_k1(k1, run, seen=set())
        after = [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]
    finally:
        engine_mod.preprocess_images = real
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    differ = []
    for sample, comp in seen:
        i = next(i for i, f in enumerate(frames) if torch.equal(torch.from_numpy(f[::97, ::89]), sample))
        differ.append(int((comp != one[i]).sum()))
    return {"calls": len(seen), "errors": errors, "alive": alive, "flags_after": after,
            "threads_pixels_differ": differ,
            "tf32_pixels_differ": [int((t != o).sum()) for t, o in zip(tf32, one)],
            "cpu_pixels_differ": [int((c != o).sum()) for c, o in zip(cpu, one)]}, calls


def phase_graft(k1, bnk, card: str, cards: int, seed: int) -> tuple[int, dict]:
    """Phase 22: ``graft_entry_torch.py``.  (a) ``entry()`` at its default
    B=8 on the card: the outputs' layout (``ENTRY_LAYOUT``), K1's and
    ``bn_act``'s launches of one call (zeroed just before, read just
    after: 2 and 58), every K1 and ``bn_act`` call of it against its plain
    version, the warm ms of a call, K1 and ``bn_act`` timed at its shapes;
    (b) ``dryrun_multichip(1)`` in this process on the card, its K1 calls
    against the plain version; (c) with ``cards`` ≥ 2, ``dryrun_multichip``
    over that many cards (NCCL, a process a card), each rank holding a
    context on its own card only (``active_contexts`` in each rank); (d)
    ``tf32_threads``.  Returns K1's launches over (a) and (b) and the
    phase's record."""
    import inspect

    import torch

    import graft_entry_torch as graft
    from chessvision_tpu_torch.models.layers import BatchNorm2d
    from chessvision_tpu_torch.tools.microbench import warp_times

    t_phase = time.perf_counter()
    rec: dict = {"seconds": {}}
    t0 = time.perf_counter()
    fn, (images, threshold) = graft.entry()
    fn(images, threshold)  # warm-up: cuDNN algorithm choice at the base-64 UNet's shapes
    torch.cuda.synchronize()
    rec["seconds"]["entry_first_call"] = time.perf_counter() - t0

    # (a) one call counted and captured
    k1.zero_launches()
    bnk.launches = 0
    (out, calls), bn_calls = capture_bn(lambda: capture_k1(k1, lambda: fn(images, threshold)))
    torch.cuda.synchronize()
    launches = k1.launches
    by_kernel = {k: v for k, v in k1.kernel_launches.items() if v}
    rec["entry_launches"] = {"k1": launches, "k1_by_kernel": dict(by_kernel), "bn_act": bnk.launches}
    if launches != 2 or by_kernel != {"warp_pass1": 1, "warp_pass2": 1} or bnk.launches != 58:
        fail(f"graft: entry()'s call launched K1 {launches} {by_kernel} and bn_act {bnk.launches} times "
             "(expected 2: pass 1 and pass 2; and 58)")
    b = images.shape[0]
    layout = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."), v.device.type) for k, v in out.items()}
    want = {k: ((b, *shape), dtype, "cuda") for k, (shape, dtype) in ENTRY_LAYOUT.items()}
    if layout != want or not bool(torch.isfinite(out["probabilities"]).all()):
        fail(f"graft: entry()'s outputs {layout}, expected {want} and finite probabilities")
    errs = check_captured(k1, calls, "graft entry")
    for a in bn_calls:
        check_bn(bnk, a)
    rec["bn_act_checked"] = len(bn_calls)
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn(images, threshold)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec["entry_ms"] = {"p50": percentile(ms, 0.5), "min": min(ms), "all": ms}
    warp = calls["warp_twopass"][0]
    rec["k1"] = {"shape": [list(warp[0].shape), *warp[2:]], **warp_times(*warp, 2, HBM_BYTES_PER_S)}
    closure = inspect.getclosurevars(fn).nonlocals
    bns = [m for part in ("extractor", "classifier") for m in closure[part].modules() if isinstance(m, BatchNorm2d)]
    rec["bn_act"] = time_bn(bnk, bn_calls[0], next(m for m in bns if m.running_mean is bn_calls[0][1]))
    del calls, bn_calls, warp, out
    log(f"[graft] entry() B={b} on the card: {json.dumps({k: list(v[0]) for k, v in layout.items()})}; "
        f"K1 {launches} launches {json.dumps(by_kernel)}, bn_act {rec['entry_launches']['bn_act']}; "
        f"one call warm p50 {rec['entry_ms']['p50']:.2f} ms (min {rec['entry_ms']['min']:.2f}); {card}")
    log(f"[graft] K1 at entry()'s shape {rec['k1']['shape']}: {rec['k1']['ms']:.4f} ms against its bound "
        f"{rec['k1']['bound_ms']:.4f}, plain {rec['k1']['plain_ms']:.2f}, F.grid_sample twice "
        f"{rec['k1']['library_ms']:.4f}; bn_act at {rec['bn_act']['shape']}: {rec['bn_act']['ms']:.4f} ms against "
        f"its bound {rec['bn_act']['bound_ms']:.4f}, plain {rec['bn_act']['plain_ms']:.4f}, eager "
        f"{rec['bn_act']['library_ms']:.4f}; {card}")

    # (b) the dry run on a mesh of one, in this process
    printed: list = []
    k1.zero_launches()
    t0 = time.perf_counter()
    with stdout_captured(printed):
        recs, calls = capture_k1(k1, lambda: graft.dryrun_multichip(1))
    torch.cuda.synchronize()
    rec["seconds"]["dryrun_1"] = time.perf_counter() - t0
    rec["dryrun_1_launches"] = {k: v for k, v in k1.kernel_launches.items() if v}
    launches += k1.launches
    for name, n in rec["dryrun_1_launches"].items():
        by_kernel[name] = by_kernel.get(name, 0) + n
    problems = dryrun_problems(recs, 1, printed[0])
    if recs[0]["device"] != "cuda:0" or k1.launches != 2:
        problems.append(f"device {recs[0]['device']}, K1 launches {k1.launches}")
    if problems:
        fail(f"graft: dryrun_multichip(1): {problems}")
    errs.update(check_captured(k1, calls, "graft dryrun_multichip(1)"))
    rec["dryrun_1"] = {k: recs[0][k] for k in ("device", "seg_loss", "cls_loss", "line")}
    del calls

    # (d) two threads with the caller's TF32 on: full float32 in every call
    t0 = time.perf_counter()
    rec["threads"], calls = tf32_threads(k1, seed)
    rec["seconds"]["threads"] = time.perf_counter() - t0
    th = rec["threads"]
    log(f"[graft] two threads, 12 calls of process_batch on 12 MP frames with TF32 on outside: comp differs "
        f"from one thread's full-float32 comp in {th['threads_pixels_differ']} pixels; flags after "
        f"{th['flags_after']}; a TF32 resize would move {th['tf32_pixels_differ']} pixels a frame; the card's "
        f"full-float32 comp differs from the CPU's in {th['cpu_pixels_differ']}")
    if th["errors"] or th["alive"] or th["calls"] != 12 or any(th["threads_pixels_differ"]) \
            or th["flags_after"] != [True, True]:
        fail(f"graft: two threads' process_batch: {json.dumps(th)}")
    errs.update(check_captured(k1, calls, "graft threads"))
    del calls

    # (c) over the cards, one NCCL rank a card
    if cards >= 2:
        printed = []
        t0 = time.perf_counter()
        with stdout_captured(printed):
            recs = graft.dryrun_multichip(cards, probe=active_contexts)
        rec["seconds"][f"dryrun_{cards}"] = time.perf_counter() - t0
        problems = dryrun_problems(recs, cards, printed[0])
        for r in recs:
            if r["backend"] != "nccl" or r["device"] != f"cuda:{r['rank']}" or r["probe"] != [r["rank"]]:
                problems.append(f"rank {r['rank']} on {r['device']} over {r['backend']} holds contexts on cards "
                                f"{r['probe']}, expected [{r['rank']}]")
        if problems:
            fail(f"graft: dryrun_multichip({cards}): {problems}")
        rec[f"dryrun_{cards}"] = [{k: r[k] for k in ("rank", "device", "pid", "probe", "seg_loss", "cls_loss")}
                                  for r in recs]
        log(f"[graft] dryrun_multichip({cards}) over NCCL: each rank holds a context on its own card only "
            f"({[r['probe'] for r in recs]}) in {rec['seconds'][f'dryrun_{cards}']:.1f} s")
    else:
        log("[graft] (c) dryrun_multichip over several cards needs --cards N or a machine with two or more: not run")
    rec["launches_by_kernel"] = by_kernel
    rec["max_abs_err"] = max(e for case in errs.values() for e in case.values())
    # the path's bn_act launches: the counted call's, not the comparisons' and the timings'
    bnk.launches = rec["entry_launches"]["bn_act"]
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"[graft] K1 launches {launches} {json.dumps(by_kernel)}, max |kernel - plain| {rec['max_abs_err']}; "
        f"seconds {json.dumps(rec['seconds'])}")
    return launches, rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="also print stage times, device busy share and peak memory")
    ap.add_argument("--load-client", nargs=2, metavar=("PORT", "BODIES"), help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", nargs=5, metavar=("RANK", "WORLD", "PORT", "OUT", "SEED"), help=argparse.SUPPRESS)
    ap.add_argument("--cli-trainers", nargs=4, metavar=("ROOT", "PORT", "OUT", "SEED"), help=argparse.SUPPRESS)
    ap.add_argument("--cards", type=int, default=None,
                    help="run phase 16 over N cards (fails with fewer); default: every card, where there are two or more")
    ap.add_argument("--only", choices=["multicard", "graft"], default=None,
                    help="build the kernels, then run phase 16 (or 22) alone")
    ap.add_argument("--multicard-child", nargs=5, metavar=("RANK", "WORLD", "PORT", "OUT", "SEED"), help=argparse.SUPPRESS)
    ap.add_argument("--edges-child", nargs=2, metavar=("OUT", "SEED"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.load_client:  # the server phase's own child process
        return load_client(int(args.load_client[0]), args.load_client[1])
    if args.mesh_child:  # one rank of the parallel phase
        r, w, port, out, seed = args.mesh_child
        return mesh_child(int(r), int(w), int(port), out, int(seed))
    if args.cli_trainers:  # the parallel phase's world-size-1 trainers
        root, port, out, seed = args.cli_trainers
        return cli_trainers_child(root, int(port), out, int(seed))
    if args.multicard_child:  # one rank of phase 16
        r, w, port, out, seed = args.multicard_child
        return multicard_child(int(r), int(w), int(port), out, int(seed))
    if args.edges_child:  # one child of phase 18
        return edges_child(args.edges_child[0], int(args.edges_child[1]))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from chessvision_tpu_torch import constants, cuda_build, profiling
    from chessvision_tpu_torch import engine as engine_mod
    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.models.layers import BatchNorm2d
    from chessvision_tpu_torch.ops import bn_act as bnk
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
    n_cards = torch.cuda.device_count()
    if args.cards is not None and not 1 <= args.cards <= n_cards:
        print(f"chip_smoke: --cards {args.cards} needs that many cards; this machine shows {n_cards}", file=sys.stderr)
        return 2
    cards = args.cards or (n_cards if n_cards >= 2 else 0)
    if args.only == "multicard" and not cards:
        print("chip_smoke: --only multicard needs --cards N or a machine with two or more cards", file=sys.stderr)
        return 2

    # -- 1. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    names = cuda_build.build_all(verbose=True)
    log(f"[build] {names} in {time.perf_counter() - t0:.1f} s")

    if args.only == "multicard":
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
            by_card, multicard = phase_multicard(k1, args.seed, root, cards, card)
        log(f"[multicard] summary {json.dumps({k: v for k, v in multicard.items() if k != 'binding'})}")
        t = multicard["k1"]["times"]["cuda:0"]["segmentation"]
        kernels = [{
            "name": "hat_resample",
            "route": "cuda",
            "source": "chessvision_tpu_torch/csrc/hat_resample.cu",
            "replaces": "chessvision_tpu/ops/pallas_kernels.py:123",
            "launches": sum(by_card.values()),
            "max_abs_err": multicard["k1"]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "launches_by_card": by_card,
            "multicard_shapes": multicard["k1"]["times"],
        }]
        log(f"[done] total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name, "count": n_cards}}))
        return 0

    if args.only == "graft":
        launches_graft, graft_rec = phase_graft(k1, bnk, card, cards, args.seed)
        t, tb = graft_rec["k1"], graft_rec["bn_act"]
        kernels = [
            {"name": "warp_twopass", "route": "cuda", "source": "chessvision_tpu_torch/csrc/hat_resample.cu",
             "replaces": "chessvision_tpu/ops/pallas_kernels.py:123", "launches": launches_graft,
             "max_abs_err": graft_rec["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
             "launches_by_kernel": graft_rec["launches_by_kernel"], "shape": t["shape"]},
            {"name": "bn_act", "route": "cuda", "source": "chessvision_tpu_torch/csrc/bn_act.cu",
             "replaces": "none: no TPU kernel; XLA's fusion of Flax's BatchNorm, ReLU and the cast "
                         "(chessvision_tpu/models/unet.py:31, chessvision_tpu/models/resnet.py:26)",
             "launches": graft_rec["entry_launches"]["bn_act"], "max_abs_err": 0.0, "ms": tb["ms"],
             "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"], "bound_by": "bytes",
             "library_ms": tb["library_ms"], "shape": tb["shape"]},
        ]
        log(f"[graft] summary {json.dumps({k: v for k, v in graft_rec.items() if k not in ('k1', 'bn_act')})}")
        log(f"[done] total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name, "count": n_cards}}))
        return 0

    # -- 2. main path ----------------------------------------------------------------
    frames8, _ = board_frames(args.seed, 8)
    cv = ChessVision(device="cuda")  # bfloat16 models, refine="arbitrate", margin 32
    engine = cv.engine
    engine.process_batch(frames8)  # warm-up: cuDNN algorithm choice, lazy inits
    torch.cuda.synchronize()

    k1.zero_launches()
    bnk.launches = 0
    single = cv.process_image(frames8[0])
    (res8, calls8), bn_calls8 = capture_bn(lambda: capture_k1(k1, lambda: engine.process_batch(frames8)))
    torch.cuda.synchronize()
    launches = k1.launches
    k1_main = dict(k1.kernel_launches)  # by kernel, over the main path's calls (phases 2 and 4)
    bn_by_path = {"main": bnk.launches}
    # bn_act once a BatchNorm layer of the UNet, twice of the ResNet18 (the two arbitrate passes)
    n_bn = sum(isinstance(m, BatchNorm2d) for m in engine._extractor.modules()) + 2 * sum(
        isinstance(m, BatchNorm2d) for m in engine._classifier.modules())
    log(f"[main] bn_act launches over process_image + process_batch: {bnk.launches} "
        f"({len(bn_calls8)} distinct calls in process_batch)")
    if bnk.launches != 2 * n_bn:
        raise SystemExit(f"FAIL: expected {2 * n_bn} bn_act launches ({n_bn} a pipeline call), got {bnk.launches}")
    log(f"[main] process_image found={single.board_extraction.quadrangle is not None} "
        f"fen={single.position.fen if single.position else ''!r}")
    log(f"[main] process_batch B=8 found={res8.board_found.tolist()} fens={res8.fens}")
    log(f"[main] K1 launches over process_image + process_batch: {launches}; entries called in "
        f"process_batch: {({k: len(v) for k, v in calls8.items()})}")
    if launches != 4 or k1_main["warp_pass1"] != 2 or k1_main["warp_pass2"] != 2:
        raise SystemExit(f"FAIL: expected 4 K1 launches (pass 1 and pass 2 a pipeline call), got {launches}: "
                         f"{k1_main}")
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

    # -- 3. the same batch through the plain versions of K1 and bn_act ------------------------
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
    k1.zero_launches()
    bnk.launches = 0
    (res128, calls128), bn_calls128 = capture_bn(lambda: capture_k1(k1, lambda: engine.process_batch(frames128)))
    torch.cuda.synchronize()
    launches128 = k1.launches
    k1_main = {k: n + k1.kernel_launches[k] for k, n in k1_main.items()}
    bn_by_path["main"] += bnk.launches
    log(f"[main] K1 launches over process_batch B={bsz}: {launches128}; bn_act {bnk.launches}")
    if launches128 != 2 or bnk.launches != n_bn:
        raise SystemExit(f"FAIL: expected 2 K1 and {n_bn} bn_act launches at B={bsz}, got {launches128}, {bnk.launches}")
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
    log(f"[k1] B={bsz} routes: warp_plan picks {k1_128['route']}; two-pass {k1_128['twopass_ms']:.4f} ms "
        f"(cold {k1_128['twopass_cold_ms']:.4f}), fused {k1_128['fused_ms']:.4f} ms (cold "
        f"{k1_128['fused_cold_ms']:.4f}); routes differ by {k1_128['routes_max_abs_diff']}; each pass alone: "
        f"pass 1 {k1_128['pass1_ms']:.4f} ms against its floor {k1_128['pass1_floor_ms']:.4f} (plain "
        f"{k1_128['pass1_plain_ms']:.2f}, grid_sample {k1_128['pass1_library_ms']:.4f}), pass 2 "
        f"{k1_128['pass2_ms']:.4f} against {k1_128['pass2_floor_ms']:.4f} (plain {k1_128['pass2_plain_ms']:.2f}, "
        f"grid_sample {k1_128['pass2_library_ms']:.4f})")
    del calls8, calls128, warp128

    # bn_act against its plain version, bit for bit: every call shape of the bf16 models at B=8 and
    # B=128 and of the float32 models at B=8, then the seeded edge cases
    cv32 = ChessVision(device="cuda", dtype=torch.float32)
    _, bn_calls32 = capture_bn(lambda: cv32.engine.process_batch(frames8))
    bn_cases = {"B=8 bfloat16": bn_calls8, f"B={bsz} bfloat16": bn_calls128, "B=8 float32": bn_calls32,
                **bn_edge_cases(args.seed)}
    for case in bn_cases.values():
        for a in case:
            check_bn(bnk, a)
    bn_checked = {k: len(v) for k, v in bn_cases.items()}
    log(f"[bn_act] equal to its plain version in every bit on {sum(bn_checked.values())} inputs: "
        f"{json.dumps(bn_checked)}")

    def bn_module(a):
        mods = (*engine._extractor.modules(), *engine._classifier.modules())
        return next(m for m in mods if isinstance(m, BatchNorm2d) and m.running_mean is a[1])

    # the UNet's first layer (inc.bn1: bf16 in and out, ReLU) and a ResNet18 block (bn2 + residual + ReLU)
    bn_times = {"unet_inc": time_bn(bnk, bn_calls128[0], bn_module(bn_calls128[0]))}
    block = next(a for a in bn_calls128 if a[4] is not None)
    bn_times["resnet_block"] = time_bn(bnk, block, bn_module(block))
    for name, t in bn_times.items():
        log(f"[bn_act] B={bsz} {name} {json.dumps(t)}: kernel {t['ms']:.4f} ms against its bound "
            f"{t['bound_ms']:.4f} ms ({100 * t['bound_ms'] / t['ms']:.1f}%), plain {t['plain_ms']:.4f} ms, "
            f"F.batch_norm + F.relu + cast {t['library_ms']:.4f} ms")
    del bn_calls8, bn_calls32, bn_calls128, bn_cases, block

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
    def counted(path: str, fn):
        """``fn()`` with bn_act's count zeroed just before and read just after."""
        bnk.launches = 0
        out = fn()
        torch.cuda.synchronize()
        bn_by_path[path] = bnk.launches
        return out

    counted("codecs", lambda: phase_codecs(engine, engine_mod, constants, frames8, limit_chroma(frames8)))
    launches_stream, errs_stream = counted("stream", lambda: phase_stream(engine, engine_mod, k1, frames128,
                                                                          args.profile))
    launches_yolo, errs_yolo = counted("yolo", lambda: phase_yolo(k1, frames8))
    launches_server, errs_server = counted("server", lambda: phase_server(k1, frames8))
    errs_serving = {**errs_stream, **errs_yolo, **errs_server}
    log(f"[k1] max |kernel - plain| on the serving paths' inputs: {json.dumps(errs_serving)}")
    worst = max(worst, *(e for case in errs_serving.values() for e in case.values()))

    # -- 10–12. augmentation, training, evaluation --------------------------------------------
    launches_augment, errs_augment, k1_augment = counted("augment", lambda: phase_augment(k1, args.seed))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        launches_train, train_results = counted("train", lambda: phase_train(k1, args.seed, root, frames8,
                                                                             args.profile))
        launches_eval, agg12 = counted("eval", lambda: phase_eval(k1, args.seed, root))
        # -- 13–14. data parallelism, the data tools --------------------------------------------------
        launches_parallel, parallel = counted("parallel", lambda: phase_parallel(k1, args.seed, root, res128, frames8))
        launches_data, data_res = counted("data", lambda: phase_data(k1, args.seed, root, frames128))
        # -- 15. the launchers ---------------------------------------------------------------------
        launches_launchers, launchers = counted("launchers", lambda: phase_launchers(k1, args.seed, root, card,
                                                                                     frames8, agg12))
        # -- 16. across cards ------------------------------------------------------------------------
        by_card, multicard = {}, None
        if cards:
            by_card, multicard = counted("multicard", lambda: phase_multicard(k1, args.seed, root, cards, card,
                                                                              res128))
        else:
            log(f"[multicard] phase 16 needs --cards N or a machine with two or more cards; this one shows "
                f"{n_cards}: not run")
    # -- 17. camera-size photos ---------------------------------------------------------------------
    launches_photos, photos = counted("photos", lambda: phase_photos(k1, cv, args.seed))
    # -- 18. an empty batch and the environment ------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        launches_edges, edges = counted("edges", lambda: phase_edges(k1, cv, args.seed, root))
    # -- 19. the measuring tools --------------------------------------------------------------------
    launches_measure, measure = counted("measure", lambda: phase_measure(k1, cv, card))
    # -- 20. memory at B=1024, the load test, hard-example weights ------------------------------------
    launches_memory, memory = counted("memory", lambda: phase_memory(k1, cv, card, args.seed, measure["sweep"]))
    # -- 21. the programs that read the test set ---------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        launches_testset, testset = counted("testset", lambda: phase_testset(k1, cv, args.seed, root, card))
    # -- 22. graft_entry_torch.py: entry() and the dry run ------------------------------------------
    launches_graft, graft_rec = counted("graft", lambda: phase_graft(k1, bnk, card, cards, args.seed))
    # every path that runs the UNet or the ResNet18 in this process (the YOLO pair keeps its eager
    # BatchNorm + SiLU, augmentation runs no model, the parallel and multicard ranks are processes of their own)
    idle = [p for p, n in bn_by_path.items() if n == 0 and p not in ("yolo", "augment", "parallel", "multicard")]
    log(f"[bn_act] launches by path: {json.dumps(bn_by_path)}")
    if idle:
        fail(f"bn_act never launched on the paths {idle}")
    worst = max(worst, parallel["k1_max_abs_err"], data_res["k1_max_abs_err"], launchers["k1_max_abs_err"],
                photos["max_abs_err"], edges["max_abs_err"], measure["max_abs_err"], testset["max_abs_err"],
                graft_rec["max_abs_err"])
    log(f"[parallel] summary {json.dumps({k: v for k, v in parallel.items() if k != 'cli'})}")
    log(f"[data] summary {json.dumps(data_res)}")
    log(f"[k1] max |kernel - plain| on the augmentation inputs: {json.dumps(errs_augment)}")
    worst = max(worst, *(e for case in errs_augment.values() for e in case.values()))
    log(f"[main] K1 launches by path: process_image + process_batch {launches}, run_stream {launches_stream}, "
        f"yolo {launches_yolo}, server {launches_server}, augment {launches_augment}, train {launches_train}, "
        f"eval {launches_eval}, parallel {launches_parallel} (every rank's), data {launches_data}, "
        f"launchers {launches_launchers}, photos {launches_photos}, edges {launches_edges}, "
        f"measure {launches_measure}, memory {launches_memory}, testset {launches_testset}, graft {launches_graft}")
    log(f"[train] summary {json.dumps({k: v['timing'] for k, v in train_results.items()})}")

    # f32 parity mode on the card (TF32 off): informational agreement with bf16
    res32 = cv32.engine.process_batch(frames8)
    agree = sum(a == b for a, b in zip(res32.fens, res8.fens))
    log(f"[f32] found equal={bool((res32.board_found == res8.board_found).all())}, "
        f"FENs equal bf16 vs f32: {agree}/8")

    # K1's three kernels: the two-pass route's two, timed at the main path's B=128 512² (their launches:
    # phases 2 and 4's pipeline calls and phase 22's), and the fused route's one, timed at the 12 MP photo
    # (its launches: phase 17's pipeline calls, the path of the photos users send)
    k1_launches_all = (launches + launches_stream + launches_yolo + launches_server + launches_augment
                       + launches_train + launches_eval + launches_parallel + launches_data + launches_launchers
                       + launches_photos + launches_edges + launches_measure + launches_memory
                       + launches_testset + launches_graft + sum(by_card.values()))
    k1_worst = max(worst, multicard["k1"]["max_abs_err"] if multicard else 0.0)
    k1_common = {"route": "cuda", "source": "chessvision_tpu_torch/csrc/hat_resample.cu",
                 "replaces": "chessvision_tpu/ops/pallas_kernels.py:123", "max_abs_err": k1_worst,
                 "bound_by": "bytes", "k1_launches_all_paths": k1_launches_all}
    photo12 = photos["k1"]["12MP"]
    kernels = [
        {"name": f"warp_{p}", **k1_common,
         "launches": k1_main[f"warp_{p}"] + graft_rec["launches_by_kernel"].get(f"warp_{p}", 0),
         "launches_by_path": {"main": k1_main[f"warp_{p}"],
                              "graft": graft_rec["launches_by_kernel"].get(f"warp_{p}", 0)},
         "ms": k1_128[f"{p}_ms"],
         "plain_ms": k1_128[f"{p}_plain_ms"], "bound_ms": k1_128[f"{p}_floor_ms"],
         "library_ms": k1_128[f"{p}_library_ms"], "shape": k1_128["shape"]}
        for p in ("pass1", "pass2")
    ]
    kernels[0].update(
        warp_twopass_b128={k: k1_128[k] for k in ("ms", "twopass_ms", "twopass_cold_ms", "fused_ms", "fused_cold_ms",
                                                   "plain_ms", "library_ms", "bound_ms", "route")},
        augment_shapes={name: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "two_kernel_floor_ms")}
                        for name, t in k1_augment.items()})
    # at B=1 back-to-back calls measure the host's launches, so the fused kernel's and the yardstick's
    # ms are device times of single calls after an L2 flush (the back-to-back ones beside them)
    kernels.append({
        "name": "warp_fused", **k1_common, "launches": photos["launches_by_kernel"]["warp_fused"],
        "ms": photo12["fused_cold_ms"], "plain_ms": photo12["fused_plain_ms"], "bound_ms": photo12["bound_ms"],
        "library_ms": photo12["library_cold_ms"], "library": "F.grid_sample twice (cuDNN off), positions given",
        "ms_back_to_back": photo12["fused_ms"], "library_ms_back_to_back": photo12["library_ms"],
        "shape": photo12["shape"],
        "photo_shapes": {name: {k: t[k] for k in ("route", "fused_ms", "fused_cold_ms", "twopass_ms", "twopass_cold_ms",
                                                  "pass1_ms", "pass2_ms", "fused_plain_ms", "plain_ms", "library_ms",
                                                  "library_cold_ms", "bound_ms", "tap_bytes", "pass1_plan", "shape")}
                         for name, t in photos["k1"].items()},
    })
    idle_k1 = [k["name"] for k in kernels if not k["launches"]]
    if idle_k1:
        fail(f"K1 kernels {idle_k1} never launched on their paths")
    t = bn_times["unet_inc"]
    kernels.append({
        "name": "bn_act",
        "route": "cuda",
        "source": "chessvision_tpu_torch/csrc/bn_act.cu",
        "replaces": "none: no TPU kernel; XLA's fusion of Flax's BatchNorm, ReLU and the cast "
                    "(chessvision_tpu/models/unet.py:31, chessvision_tpu/models/resnet.py:26)",
        "launches": sum(bn_by_path.values()),
        "max_abs_err": 0.0,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "launches_by_path": bn_by_path,
        "shapes": bn_times,
        "checked_inputs": bn_checked,
    })
    log(f"[memory] summary {json.dumps(memory)}")
    log(f"[testset] summary {json.dumps(testset)}")
    log(f"[graft] summary {json.dumps(graft_rec)}")
    if multicard:
        kernels[0].update(launches_by_card=by_card, multicard_shapes=multicard["k1"]["times"])
        log(f"[multicard] summary {json.dumps({k: v for k, v in multicard.items() if k != 'binding'})}")
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name, "count": n_cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
