"""K1: the linear (hat) resample under both passes of the two-pass warp.

``out[n, u] = Σ_j max(0, 1 − |pos[n, u] − j|) · src[n, j]`` with a zero
border.  Replaces the TPU kernel ``chessvision_tpu/ops/pallas_kernels.py:
banded_resample``; the JAX package's ``warp._hat_resample_last_axis`` is
the same function and the oracle.  The kernels are hand-written CUDA,
``csrc/hat_resample.cu``; both entries are bound by device-memory bytes.

- ``warp_twopass``: what the main path calls, the whole two-pass warp from
  the images and the inverse homographies.  On CUDA tensors it takes the
  route that ``warp_plan`` names from the shapes alone, and the call
  raises if its launch fails:
  - ``"twopass"`` (the main path's 512² frames, the augmentations): two
    kernel launches (``warp_pass1``, ``warp_pass2``).  Pass 1 stages
    source rows in shared memory (``pass1_plan``: 8, 4, 2 or 1 rows a
    block by the width, and rows too wide for any of it read from device
    memory, so every width runs); pass 2 reads the intermediate's
    columns in place and writes the result in its final layout.  What
    moves through device memory is the images, the intermediate (written
    and read once) and the result.
  - ``"fused"`` (frames the warp shrinks: the camera photos users send):
    one launch (``warp_fused``) that computes each output from the four
    source floats it depends on, reading only its taps' sectors; no
    intermediate.
  Each thread computes its own sample positions in registers, rounding
  every operation as the plain version's eager ops do, so no position
  tensor is built or read, and both routes give the same floats.
- ``hat_resample``: the TPU kernel's own signature, positions given.  Not
  on the main path.  On CUDA tensors the kernel reads ``src`` in place
  through its batch, row and element strides (a transposed view needs no
  copy) or the call raises.
- ``warp_fused_plain``: what ``warp_twopass`` computes on CPU tensors.
  Each canvas pixel is gathered from its four taps by K1's tap rule, the
  rule both card routes compute: on finite inputs the JAX oracle's
  floats, and 0 where no tap lies inside (a non-finite position) where
  the oracle gives NaN.  A tap outside the frame reads index 0 at weight
  0, so a non-finite pixel in row 0 or column 0 reaches more outputs here
  than on the card, which selects 0 for such a tap.
- ``warp_twopass_plain``, ``twopass_positions``, ``hat_resample_plain``:
  the plain versions of the two-pass kernels and of ``hat_resample``, and
  the dense form the JAX package computes (positions as tensors; the
  broadcast multiply-reduce of the TPU kernel's band contraction).
  ``hat_resample`` takes ``hat_resample_plain`` on CPU tensors.  On the
  card the kernels are compared with them; on the CPU the tests hold them
  against the JAX package (``tests/test_torch_warp_fused.py``,
  ``tests/test_torch_warp_route.py``).
- ``launches``: kernel launches so far (any entry), to show that a run
  went through the kernels; ``kernel_launches`` the same by kernel.  A
  call whose result has no element reaches the launcher, which launches
  nothing and says so; it does not count.
"""

from __future__ import annotations

import ctypes

import torch

from chessvision_tpu_torch import cuda_build

launches = 0
kernel_launches = dict.fromkeys(("warp_pass1", "warp_pass2", "warp_fused", "hat_resample"), 0)
# the kernels each route of warp_twopass launches
ROUTE_KERNELS = {"twopass": ("warp_pass1", "warp_pass2"), "fused": ("warp_fused",)}

# rows per block of the plain version: its (rows, J, U) weight buffer is
# bounded to ~2^26 floats (256 MB) instead of growing with the batch
_PLAIN_ELEMS = 1 << 26

# limits of csrc/hat_resample.cu: the most source rows a pass-1 block
# owns, the most shared memory a block can have, and gridDim.z
_P1_ROWS = 8
_SHARED_BYTES = 232448
_GRID_Z = 65535
# a launcher's return when the shape holds no output element
_NOTHING_LAUNCHED = -1
# warp_plan: the fused route from frames this many times the canvas's
# height.  The sweep on an H100 (PERF.md §6): at B=1 the fused kernel wins
# from height 1024 (1.8× the canvas) up, at B=128 512² (0.9×) the two
# passes win 2.1×; at B=1 512 the fused kernel would save 4–13 µs, which
# the rule gives up so that every 512² frame takes one route
FUSED_MIN_RATIO = 1.5


def hat_resample_plain(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(..., J) rows resampled at (..., U) positions, by the full-width
    broadcast multiply-reduce.  At most two terms of each sum are nonzero,
    so any summation order gives the same float."""
    j = src.shape[-1]
    lead = src.shape[:-1]
    src2 = src.reshape(-1, j).float()
    pos2 = pos.reshape(-1, pos.shape[-1]).float()
    jj = torch.arange(j, dtype=torch.float32, device=src.device)
    rows = max(1, _PLAIN_ELEMS // (j * pos2.shape[-1]))
    out = torch.empty_like(pos2)
    for r0 in range(0, src2.shape[0], rows):
        p = pos2[r0 : r0 + rows]
        w = torch.clamp_min(1.0 - torch.abs(p[:, None, :] - jj[:, None]), 0.0)  # (r, J, U)
        out[r0 : r0 + rows] = torch.sum(w * src2[r0 : r0 + rows, :, None], dim=-2)
    return out.reshape(*lead, pos.shape[-1])


def _guard(den: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(den) < 1e-8, torch.full_like(den, 1e-8), den)


def _position_hx(minv: torch.Tensor, us: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Pass 1's position hx(u, y) = X(u, v*) with Y(u, v*) = y, for (B, 3, 3)
    inverse homographies at column ``us`` and source row ``ys`` (broadcast
    to (B, ...)); one rounded operation at a time, as the kernels'
    ``position_hx``."""
    (a_, b_, c_), (d_, e_, f_), (g_, h_, i_) = ([minv[:, r, k][:, None, None] for k in range(3)] for r in range(3))
    den_v = e_ - ys * h_
    v_star = (ys * (g_ * us + i_) - d_ * us - f_) / _guard(den_v)
    den_x = g_ * us + h_ * v_star + i_
    return (a_ * us + b_ * v_star + c_) / _guard(den_x)


def _position_vy(minv: torch.Tensor, us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Pass 2's position vy(u, v) = Y(u, v), as the kernels' ``position_vy``."""
    _, (d_, e_, f_), (g_, h_, i_) = ([minv[:, r, k][:, None, None] for k in range(3)] for r in range(3))
    den = g_ * us + h_ * vs + i_
    return (d_ * us + e_ * vs + f_) / _guard(den)


def twopass_positions(minv: torch.Tensor, src_h: int, out_h: int, out_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-pass warp's sample positions from (B, 3, 3) inverse
    homographies: ``hx`` (B, src_h, out_w), where pass 1 samples source row
    y for output column u, hx(u, y) = X(u, v*) with Y(u, v*) = y; and
    ``vy`` (B, out_w, out_h), where pass 2 samples column u of the
    intermediate for output row v, Y(u, v)."""
    dev = minv.device
    ys = torch.arange(src_h, dtype=torch.float32, device=dev)[:, None].expand(src_h, out_w)
    us = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(src_h, out_w)
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :].expand(out_w, out_h)
    uu = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None].expand(out_w, out_h)
    return _position_hx(minv, us, ys), _position_vy(minv, uu, vs)


def warp_twopass_plain(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The plain two-pass warp: the positions as tensors, the plain
    resample along source rows, then along the intermediate's columns."""
    hx, vy = twopass_positions(minv, imgs.shape[1], out_h, out_w)
    tmp = hat_resample_plain(imgs, hx)  # (B, src_h, out_w)
    out_t = hat_resample_plain(tmp.transpose(1, 2), vy)  # (B, out_w, out_h)
    return out_t.transpose(1, 2)


def warp_fused_plain(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The fused route's order in plain PyTorch: for each canvas pixel
    (b, v, u) the two rows r of pass 2's taps at vy(u, v), the hat sum of
    source row r at hx(u, r) for each, then the hat sum of those two at vy;
    positions by the elementwise operations of ``twopass_positions``, each
    tap weighted ``max(0, 1 − |p − j|)`` and zero outside the frame.  Equal
    to ``warp_twopass_plain`` on finite inputs: at most two terms of each of
    its sums are nonzero, and these are they."""
    b, src_h, src_w = imgs.shape
    # a board's gather peaks at ~25 floats a canvas pixel (~260 MiB for 8
    # boards into 576²): split the batch so that a block's peak stays
    # within _PLAIN_ELEMS floats
    per = max(1, _PLAIN_ELEMS // (25 * out_h * out_w))
    if b > per:
        out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=imgs.device)
        for b0 in range(0, b, per):
            out[b0 : b0 + per] = warp_fused_plain(imgs[b0 : b0 + per], minv[b0 : b0 + per], out_h, out_w)
        return out
    dev = imgs.device
    vs = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None].expand(out_h, out_w)
    us = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(out_h, out_w)
    flat = imgs.reshape(b, src_h * src_w).float()

    def taps(p: torch.Tensor, n: int):
        """The two taps of positions ``p`` along an axis of ``n``: each
        index (clamped into range for the gather) and its weight, 0 where
        the tap lies outside."""
        f = torch.floor(p)
        for j in (f, f + 1.0):
            wgt = torch.clamp_min(1.0 - torch.abs(p - j), 0.0)
            inside = (j >= 0) & (j < n)
            yield torch.where(inside, j, 0.0).long(), torch.where(inside, wgt, 0.0)

    out = torch.zeros((b, out_h, out_w), dtype=torch.float32, device=dev)
    for r, w2 in taps(_position_vy(minv, us, vs), src_h):
        row = torch.zeros_like(out)
        for col, w1 in taps(_position_hx(minv, us, r.float()), src_w):
            row = row + w1 * torch.gather(flat, 1, (r * src_w + col).reshape(b, out_h * out_w)).reshape(b, out_h, out_w)
        out = out + w2 * row
    return out


def _kernel(name: str, argtypes: list):
    fn = getattr(cuda_build.load("hat_resample"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _run(fn, name: str, device: torch.device, *args) -> None:
    """Launch on the current stream of ``device``; raise unless the launch
    was accepted; count it if the launcher launched."""
    global launches
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == _NOTHING_LAUNCHED:
        return
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches += 1
    kernel_launches[name] += 1


def zero_launches() -> None:
    """Set ``launches`` and every count of ``kernel_launches`` to 0."""
    global launches
    launches = 0
    for name in kernel_launches:
        kernel_launches[name] = 0


def _launch(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if src.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"hat_resample kernel takes float32, got {src.dtype}, {pos.dtype}")
    if src.device != pos.device:
        raise ValueError(f"src on {src.device}, pos on {pos.device}")
    if src.shape[:-1] != pos.shape[:-1]:
        raise ValueError(f"leading shapes differ: {tuple(src.shape)} vs {tuple(pos.shape)}")
    j, u = src.shape[-1], pos.shape[-1]
    # (batches, rows, J) through its own strides: a transposed view is read
    # in place (leading axes beyond the batch fold into it)
    src3 = src.reshape(1, -1, j) if src.ndim < 3 else src.flatten(0, -3)
    pos2 = pos.reshape(-1, u).contiguous()
    batches, rows = src3.shape[0], src3.shape[1]
    n = batches * rows
    if n * max(j, u) >= 2**31:
        raise ValueError(f"hat_resample kernel: shape {(n, j, u)} over the int32 index limit")
    out = torch.empty((n, u), dtype=torch.float32, device=src.device)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn = _kernel("hat_resample_launch", [ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, ptr])
    _run(fn, "hat_resample", src.device, src3.data_ptr(), pos2.data_ptr(), out.data_ptr(),
         batches, rows, j, u, *src3.stride())
    return out.reshape(*src.shape[:-1], u)


def hat_resample(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K1 with the positions given: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; any other device raises."""
    if src.is_cuda or pos.is_cuda:
        return _launch(src, pos)
    if src.device.type == "cpu" and pos.device.type == "cpu":
        return hat_resample_plain(src, pos)
    raise ValueError(f"hat_resample: unsupported device {src.device}")


def _check_warp(imgs: torch.Tensor, minv: torch.Tensor) -> None:
    if imgs.dtype != torch.float32 or minv.dtype != torch.float32:
        raise TypeError(f"warp_twopass takes float32, got {imgs.dtype}, {minv.dtype}")
    if imgs.ndim != 3 or minv.shape != (imgs.shape[0], 3, 3):
        raise ValueError(f"warp_twopass takes (B, H, W) and (B, 3, 3), got {tuple(imgs.shape)}, {tuple(minv.shape)}")
    if imgs.device != minv.device:
        raise ValueError(f"imgs on {imgs.device}, minv on {minv.device}")


def pass1_plan(w: int) -> tuple[int, int]:
    """Pass 1's launch plan for source rows of ``w`` floats: (rows a block
    owns, shared-memory bytes it stages them in).  The most rows of 8, 4,
    2 and 1 whose floats fit a block's shared memory; a row wider than all
    of it (w > 58 112) takes the kernel that reads its taps from device
    memory, (8, 0)."""
    for rows in (_P1_ROWS, 4, 2, 1):
        if rows * w * 4 <= _SHARED_BYTES:
            return rows, rows * w * 4
    return _P1_ROWS, 0


def warp_pass1(imgs: torch.Tensor, minv: torch.Tensor, out_w: int) -> torch.Tensor:
    """Pass 1 on the card: (B, H, W) source rows resampled at hx →
    (B, H, out_w).  One kernel launch, for any width."""
    _check_warp(imgs, minv)
    if not (imgs.is_cuda and imgs.is_contiguous() and minv.is_contiguous()):
        raise ValueError("warp_twopass kernel takes contiguous CUDA tensors")
    b, h, w = imgs.shape
    rows, smem = pass1_plan(w)
    if h * max(w, out_w) >= 2**31 or b * -(-h // rows) >= 2**31:
        raise ValueError(f"warp_twopass kernel: shape {(b, h, w, out_w)} over the int32 index limit")
    tmp = torch.empty((b, h, out_w), dtype=torch.float32, device=imgs.device)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = _kernel("warp_pass1_launch", [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr])
    _run(fn, "warp_pass1", imgs.device, imgs.data_ptr(), minv.data_ptr(), tmp.data_ptr(),
         b, h, w, out_w, rows, smem)
    return tmp


def warp_pass2(tmp: torch.Tensor, minv: torch.Tensor, out_h: int) -> torch.Tensor:
    """Pass 2 on the card: the columns of (B, H, out_w) resampled at vy →
    (B, out_h, out_w), read and written in place of any transpose.  One
    kernel launch."""
    _check_warp(tmp, minv)
    if not (tmp.is_cuda and tmp.is_contiguous() and minv.is_contiguous()):
        raise ValueError("warp_twopass kernel takes contiguous CUDA tensors")
    b, h, out_w = tmp.shape
    if max(h, out_h) * out_w >= 2**31 or b > _GRID_Z:
        raise ValueError(f"warp_twopass kernel: shape {(b, h, out_h, out_w)} over the kernel's index limits")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=tmp.device)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = _kernel("warp_pass2_launch", [ptr, ptr, ptr, i32, i32, i32, i32, ptr])
    _run(fn, "warp_pass2", tmp.device, tmp.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, out_h, out_w)
    return out


def warp_fused(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The fused route on the card: (B, H, W) images warped by (B, 3, 3)
    inverse homographies straight to (B, out_h, out_w).  One kernel
    launch."""
    _check_warp(imgs, minv)
    b, h, w = imgs.shape
    if max(h * w, out_h * out_w) >= 2**31 or b > _GRID_Z:
        raise ValueError(f"warp_twopass kernel: shape {(b, h, w, out_h, out_w)} over the kernel's index limits")
    if not (imgs.is_cuda and imgs.is_contiguous() and minv.is_contiguous()):
        raise ValueError("warp_twopass kernel takes contiguous CUDA tensors")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=imgs.device)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = _kernel("warp_fused_launch", [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr])
    _run(fn, "warp_fused", imgs.device, imgs.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, w, out_h, out_w)
    return out


def warp_plan(b: int, h: int, w: int, out_h: int, out_w: int) -> str:
    """The route of ``warp_twopass`` on the card for (b, h, w) frames into
    (out_h, out_w), from the shapes alone: ``"fused"`` where the warp
    shrinks the frame at least FUSED_MIN_RATIO-fold along its height,
    else ``"twopass"``.  The threshold comes from a sweep of both routes
    on an H100 (``tools/microbench.py --which route``; PERF.md §6)."""
    return "fused" if h >= FUSED_MIN_RATIO * out_h else "twopass"


def warp_twopass(imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """K1 as the main path calls it: (B, H, W) float32 images warped by
    (B, 3, 3) inverse homographies to (B, out_h, out_w).  CUDA tensors go
    through the kernels of the route ``warp_plan`` names (contiguous
    result) or the call raises; CPU tensors take ``warp_fused_plain`` (in
    ``warp_twopass_plain``'s strides); any other device raises."""
    _check_warp(imgs, minv)
    if imgs.is_cuda:
        if warp_plan(*imgs.shape, out_h, out_w) == "fused":
            return warp_fused(imgs, minv, out_h, out_w)
        return warp_pass2(warp_pass1(imgs, minv, out_w), minv, out_h)
    if imgs.device.type == "cpu":
        # warp_twopass_plain's strides, a view of (B, out_w, out_h): torch 2.13.0+cpu's oneDNN
        # backward crashes on the contiguous layout (test_a_rank_augments_only_its_rows[resnet18-*])
        return warp_fused_plain(imgs, minv, out_h, out_w).transpose(1, 2).contiguous().transpose(1, 2)
    raise ValueError(f"warp_twopass: unsupported device {imgs.device}")
