"""Time the variants of the two-pass warp that were tried and not kept.

    python -m chessvision_tpu_torch.k1_variants [--seed N] [--batch B]

Builds ``csrc/variants/k1_variants.cu`` (pass 2 with its rows staged in
shared memory; the whole warp in one kernel that stages a slab of the
intermediate in shared memory) beside the kept
kernels, checks each variant against the kept kernels' output (they must
be equal), and times all of them by CUDA events on the same seeded inputs:
``--batch`` random gray images of 512², warped to the 576² margin canvas
by quads like the synthetic frames' (rotated up to 7°) and by quads
rotated up to 30°.  Prints one JSON object; needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from chessvision_tpu_torch import cuda_build
from chessvision_tpu_torch.ops import hat_resample as k1
from chessvision_tpu_torch.ops.warp import get_perspective_transform, invert_homography


def _quads(rng: np.random.Generator, n: int, max_angle: float, size: int = 512) -> np.ndarray:
    """(n, 4, 2) board quads: 55–85% of the frame, rotated up to ``max_angle`` rad."""
    out = []
    for _ in range(n):
        side = rng.uniform(0.55, 0.85) * size
        center = rng.uniform(side / 2 + 4, size - side / 2 - 4, 2)
        a = rng.uniform(-max_angle, max_angle)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * side / 2
        out.append(corners @ rot.T + rng.uniform(-0.03, 0.03, (4, 2)) * side + center)
    return np.stack(out).astype(np.float32)


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA device")
    lib = cuda_build.load("variants/k1_variants")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.pass2_staged_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.warp_slab_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.pass2_staged_launch.restype = lib.warp_slab_launch.restype = i32

    b, h, w, out_h, out_w = args.batch, 512, 512, 576, 576
    rng = np.random.default_rng(args.seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w)).astype(np.float32)).cuda()
    dest = torch.tensor([[32, 32], [544, 32], [544, 544], [32, 544]], dtype=torch.float32).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((b, out_h, out_w), device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "batch": b}
    for name, angle in (("rotated_up_to_7_deg", 0.12), ("rotated_up_to_30_deg", 0.52)):
        quads = torch.from_numpy(_quads(rng, b, angle)).cuda()
        minv = invert_homography(get_perspective_transform(quads, dest.expand(b, 4, 2))).contiguous()
        tmp = k1.warp_pass1(imgs, minv, out_w)
        want = k1.warp_pass2(tmp, minv, out_h)

        def staged():
            return lib.pass2_staged_launch(tmp.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, out_h, out_w, stream)

        def slab():
            return lib.warp_slab_launch(imgs.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, w, out_h, out_w, stream)

        row = {}
        for variant, fn in (("pass2_staged", staged), ("warp_slab", slab)):
            out.zero_()
            if fn() != 0:
                raise SystemExit(f"{variant}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{variant}: differs from the kept kernels by {float((out - want).abs().max())}")
            row[f"{variant}_ms"] = _ms(fn)
        row["kept_pass1_ms"] = _ms(lambda: k1.warp_pass1(imgs, minv, out_w))
        row["kept_pass2_ms"] = _ms(lambda: k1.warp_pass2(tmp, minv, out_h))
        row["kept_warp_twopass_ms"] = _ms(lambda: k1.warp_twopass(imgs, minv, out_h, out_w))
        result[name] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
