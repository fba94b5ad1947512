"""Batched data augmentations on the device, the counterpart of
``chessvision_tpu/train/augment.py``.

Segmentation: hflip / rotate by an integer angle in [−15, 15) / color
jitter (±0.1 ×4) / 3×3 Gaussian blur, each at p=0.5, plus the optional
illumination gradient.  Classification: translate ±10%, scale 0.95–1.05
and rotate ±15° as one composed warp, photometric jitter and blur, plus the
optional dimming, contrast fade and cutout.  Every geometric transform is
a per-sample 3×3 homography executed by the two-pass warp in one batched
call per tensor: on CUDA that is kernel K1 (``ops/hat_resample.py:
warp_twopass``), two launches per call.  An unselected sample gets the
identity matrix, which the warp reproduces exactly.

Randomness: JAX's PRNG cannot be reproduced in torch, so a ``key`` here is
an integer and every random quantity is drawn from its own
``torch.Generator`` on the images' device, seeded from (key, name).
The streams are independent of one another, so turning on
``illum_gradient``, ``cutout``, ``dim`` or ``fade`` leaves every other
augmentation's draws unchanged at a key, the JAX package's rule.
``fold_in(key, i)`` derives the key of step i.

Rows of a batch: on a mesh each rank augments only its rows of the global
batch (``rows=(start, stop)``, ``global_batch=B``).  Every draw, and every
per-sample quantity derived from one (matrices, blur kernels, jitter
factors), is still made at the global batch's shape and then sliced, and
each per-image mean is reduced at the global batch's shape
(``_row_mean``); so a rank's rows equal the whole batch's augmentation
sliced to them, bit for bit, on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chessvision_tpu_torch.ops.warp import _warp_batched_twopass


def fold_in(key: int, data: int | str) -> int:
    """A new key from ``key`` and ``data`` (an int or a stream name)."""
    words = [int(key) & 0xFFFFFFFFFFFFFFFF]
    if isinstance(data, str):
        words += list(data.encode("utf-8"))
    else:
        words.append(int(data) & 0xFFFFFFFFFFFFFFFF)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _generator(key: int, name: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(key, name))
    return g


def _uniform(key: int, name: str, shape: tuple[int, ...], lo: float, hi: float, device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=_generator(key, name, device), device=device)
    return lo + (hi - lo) * u


def _row_range(n: int, rows: tuple[int, int] | None, global_batch: int | None) -> tuple[int, int, int]:
    """(start, stop, B) of ``n`` given rows in a global batch of B."""
    if rows is None:
        if global_batch not in (None, n):
            raise ValueError(f"global_batch={global_batch} needs rows= for a batch of {n}")
        return 0, n, n
    start, stop = int(rows[0]), int(rows[1])
    if global_batch is None:
        raise ValueError("rows= needs global_batch=")
    if not (0 <= start <= stop <= global_batch and stop - start == n):
        raise ValueError(f"rows {rows} of a global batch of {global_batch} do not hold the {n} rows given")
    return start, stop, int(global_batch)


def _dense_rows(x: torch.Tensor) -> bool:
    """Whether (n, ...) ``x`` is laid out row after row, each row dense."""
    dims = sorted((st, sz) for st, sz in zip(x.stride()[1:], x.shape[1:]) if sz > 1)
    step = 1
    for st, sz in dims:
        if st != step:
            return False
        step *= sz
    return x.shape[0] == 1 or x.stride(0) == step


def _row_mean(x: torch.Tensor, span: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Per-sample mean of (n, ...) float32 → (n, 1, ..., 1).  ``span`` =
    (start, stop, B) places the rows in a global batch of B: a float
    reduction's order depends on the shape and layout it runs at (CUDA's
    launch shape, the CPU's threads), so the rows are reduced inside a
    tensor of the global batch's shape and of their layout (the other rows
    zero), which gives them the bits the whole batch's mean gives them,
    and one process keeps its bits.  Costs a tensor of the global batch's
    size for each mean on every rank.  Rows not laid out row after row are
    reduced from a contiguous copy, in one process as in a rank."""
    if not _dense_rows(x):
        x = x.contiguous()
    dims = tuple(range(1, x.ndim))
    if span is None or span[1] - span[0] == span[2]:
        return x.mean(dim=dims, keepdim=True)
    start, stop, b = span
    full = torch.empty_strided((b, *x.shape[1:]), (x[0].numel(), *x.stride()[1:]), dtype=x.dtype, device=x.device)
    full[:start] = 0.0
    full[stop:] = 0.0
    full[start:stop] = x
    return full.mean(dim=dims, keepdim=True)[start:stop]


def _rotation_matrices(angles_deg: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """(B,) angles → (B, 3, 3) forward homographies rotating about the
    center."""
    theta = angles_deg * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack(
        [
            torch.stack([cos, -sin, cx - cos * cx + sin * cy], -1),
            torch.stack([sin, cos, cy - sin * cx - cos * cy], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=-2,
    )


def _affine_matrices(tx: torch.Tensor, ty: torch.Tensor, scale: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """Translate + uniform scale about the center → (B, 3, 3)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    zeros, ones = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack(
        [
            torch.stack([scale, zeros, cx + tx - scale * cx], -1),
            torch.stack([zeros, scale, cy + ty - scale * cy], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=-2,
    )


def _warp_nhwc(images: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """Batched homography warp of (B, H, W[, C]) float32 by forward
    matrices: channels fold into the batch, one two-pass warp call."""
    if images.ndim == 4:
        b, h, w, c = images.shape
        flat = images.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
        out = _warp_batched_twopass(flat, ms.repeat_interleave(c, dim=0).contiguous(), h, w)
        return out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    b, h, w = images.shape
    return _warp_batched_twopass(images.contiguous(), ms.contiguous(), h, w)


def _jitter_factors(
    apply: torch.Tensor, bright: torch.Tensor, contrast: torch.Tensor, sat: torch.Tensor, hue: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """The per-sample factors of ``_color_jitter``: brightness, contrast,
    saturation (B, 1, 1, 1), and the hue rotation's cos and sin (B, 1, 1)."""

    def per(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return torch.where(apply, v, torch.full_like(v, (lo + hi) / 2.0))[:, None, None, None]

    hshift = (per(hue, -0.1, 0.1) * 2 * math.pi)[..., 0]
    return per(bright, 0.9, 1.1), per(contrast, 0.9, 1.1), per(sat, 0.9, 1.1), torch.cos(hshift), torch.sin(hshift)


def _color_jitter(
    img: torch.Tensor,
    apply: torch.Tensor,
    bright: torch.Tensor,
    contrast: torch.Tensor,
    sat: torch.Tensor,
    hue: torch.Tensor,
) -> torch.Tensor:
    """Brightness/contrast/saturation/hue per sample on (B, H, W, 3) BGR in
    [0, 1].  ``bright``, ``contrast``, ``sat`` ~ U(0.9, 1.1) and ``hue`` ~
    U(−0.1, 0.1), each (B,); samples not in ``apply`` get the centers."""
    return _jitter_with(img, *_jitter_factors(apply, bright, contrast, sat, hue))


def _jitter_with(
    img: torch.Tensor,
    b_: torch.Tensor,
    c_: torch.Tensor,
    s_: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    span: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    img = img * b_
    mean = _row_mean(img, span)
    img = (img - mean) * c_ + mean
    gray = img[..., 2:3] * 0.299 + img[..., 1:2] * 0.587 + img[..., 0:1] * 0.114
    img = (img - gray) * s_ + gray
    r, g, bch = img[..., 2], img[..., 1], img[..., 0]
    y = 0.299 * r + 0.587 * g + 0.114 * bch
    i = 0.596 * r - 0.274 * g - 0.322 * bch
    q = 0.211 * r - 0.523 * g + 0.312 * bch
    i2 = i * cos - q * sin
    q2 = i * sin + q * cos
    r2 = y + 0.956 * i2 + 0.621 * q2
    g2 = y - 0.272 * i2 - 0.647 * q2
    b2 = y - 1.106 * i2 + 1.703 * q2
    return torch.clamp(torch.stack([b2, g2, r2], dim=-1), 0.0, 1.0)


def _gaussian_blur3(img: torch.Tensor, apply: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """3×3 Gaussian blur of (B, H, W, C) with per-sample ``sigma`` (B,),
    edge padding; the identity kernel where not applied."""
    return _blur_with(img, _blur_kernels(apply, sigma))


def _blur_kernels(apply: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(B, 3) separable Gaussian taps; the identity where not applied."""
    xs = torch.arange(-1, 2, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (xs[None, :] / sigma[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    ident = (xs == 0).float()
    return torch.where(apply[:, None], k, ident)


def _blur_with(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k0, k1, k2 = (k[:, i][:, None, None, None] for i in range(3))
    pad_h = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    img = k0 * pad_h[:, :-2] + k1 * pad_h[:, 1:-1] + k2 * pad_h[:, 2:]
    pad_w = torch.cat([img[:, :, :1], img, img[:, :, -1:]], dim=2)
    return k0 * pad_w[:, :, :-2] + k1 * pad_w[:, :, 1:-1] + k2 * pad_w[:, :, 2:]


def _illum_gradient(img: torch.Tensor, apply: torch.Tensor, strength: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Multiply (B, H, W, C) by a linear ramp 1 → (1 − s) along one of four
    axis directions (0: +x, 1: −x, 2: +y, 3: −y) where ``apply``: the
    page-gutter / page-shadow dimming of printed boards."""
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    s = torch.where(apply, strength, torch.zeros_like(strength))[:, None, None]
    tx = torch.linspace(0.0, 1.0, w, device=img.device)[None, None, :] * torch.ones((1, h, 1), device=img.device)
    ty = torch.linspace(0.0, 1.0, h, device=img.device)[None, :, None] * torch.ones((1, 1, w), device=img.device)
    ramps = torch.stack([tx, 1.0 - tx, ty, 1.0 - ty])[:, 0]  # (4, H, W)
    t = ramps[direction.long()]
    return img * (1.0 - s * t)[..., None]


def augment_segmentation_batch(
    key: int,
    images: torch.Tensor,
    masks: torch.Tensor,
    illum_gradient: bool = False,
    *,
    rows: tuple[int, int] | None = None,
    global_batch: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) float32 in [0, 1] and (B, H, W) float32 masks → the
    augmented pair (two warp calls: images, masks).  With ``rows=(start,
    stop)`` and ``global_batch``, ``images`` and ``masks`` are those rows of
    the global batch, and the result equals the whole batch's
    augmentation sliced to them."""
    h, w = images.shape[1], images.shape[2]
    start, stop, b = _row_range(images.shape[0], rows, global_batch)
    dev = images.device

    def u(name: str, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return _uniform(key, name, (b,), lo, hi, dev)

    def mine(*per_sample: torch.Tensor) -> list[torch.Tensor]:
        return [t[start:stop] for t in per_sample]

    if illum_gradient:
        direction = torch.randint(0, 4, (b,), generator=_generator(key, "illum_direction", dev), device=dev)
        images = _illum_gradient(images, *mine(u("illum_apply") < 0.3, u("illum_strength", 0.25, 0.65), direction))

    (do_flip,) = mine(u("flip") > 0.5)
    images = torch.where(do_flip[:, None, None, None], images.flip(2), images)
    masks = torch.where(do_flip[:, None, None], masks.flip(2), masks)

    do_rot = u("rotate") > 0.5
    angles = torch.randint(-15, 15, (b,), generator=_generator(key, "angle", dev), device=dev).float()
    angles = torch.where(do_rot, angles, torch.zeros_like(angles))
    (ms,) = mine(_rotation_matrices(angles, h, w))
    images = _warp_nhwc(images, ms)
    masks = _warp_nhwc(masks, ms)

    do_jit = u("jitter") > 0.5
    factors = _jitter_factors(do_jit, u("bright", 0.9, 1.1), u("contrast", 0.9, 1.1), u("saturation", 0.9, 1.1),
                              u("hue", -0.1, 0.1))
    images = _jitter_with(images, *mine(*factors), span=(start, stop, b))

    do_blur = u("blur") > 0.5
    (kernels,) = mine(_blur_kernels(do_blur, u("sigma", 0.1, 2.0)))
    images = _blur_with(images, kernels)
    return images, masks


def augment_classification_batch(
    key: int,
    images: torch.Tensor,
    photometric: bool = True,
    cutout: bool = False,
    dim: bool = False,
    fade: bool = False,
    *,
    rows: tuple[int, int] | None = None,
    global_batch: int | None = None,
) -> torch.Tensor:
    """(B, 64, 64, 1) float32 in [0, 1]: translate ±10%, scale 0.95–1.05
    and rotate ±15° as one composed warp (one call), then photometric
    jitter (brightness/contrast ×U(0.75, 1.25), p=0.5 blur).

    ``dim``: brightness ×U(0.3, 0.75) at p=0.25 (squares in a page gutter
    or shadow).  ``fade``: contrast fade toward a paper white, x → L −
    c·(L − x) with c ~ U(0.3, 0.75), L ~ U(0.55, 0.95), at p=0.25 (the
    book-gutter defocus).  ``cutout``: at p=0.5 a rectangle of 10–25% of
    each side filled with the image mean (occluding fingers).

    ``rows`` and ``global_batch`` as in ``augment_segmentation_batch``."""
    h, w = images.shape[1], images.shape[2]
    start, stop, b = _row_range(images.shape[0], rows, global_batch)
    dev = images.device

    def u(name: str, shape: tuple[int, ...], lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """The draw at the global batch's shape, sliced to the rows."""
        return _uniform(key, name, (b, *shape), lo, hi, dev)[start:stop]

    n = stop - start
    if dim:
        factor = torch.where(u("dim_apply", ()) < 0.25, u("dim_factor", (), 0.3, 0.75), torch.ones(n, device=dev))
        images = images * factor[:, None, None, None]
    if fade:
        c = torch.where(u("fade_apply", ()) < 0.25, u("fade_contrast", (), 0.3, 0.75), torch.ones(n, device=dev))
        paper = u("fade_paper", (), 0.55, 0.95)[:, None, None, None]
        # identity when c = 1 whatever the anchor; stays in [0, 1]
        images = paper - c[:, None, None, None] * (paper - images)
    # the matrices at the global batch (cos, sin and the product), then sliced
    txy = _uniform(key, "translate", (b, 2), -0.1, 0.1, dev) * w
    m_aff = _affine_matrices(txy[:, 0], txy[:, 1], _uniform(key, "scale", (b,), 0.95, 1.05, dev), h, w)
    m_rot = _rotation_matrices(_uniform(key, "angle", (b,), -15.0, 15.0, dev), h, w)
    images = _warp_nhwc(images, torch.bmm(m_rot, m_aff)[start:stop])

    if photometric:
        images = images * u("bright", (1, 1, 1), 0.75, 1.25)
        mean = _row_mean(images, (start, stop, b))
        images = (images - mean) * u("contrast", (1, 1, 1), 0.75, 1.25) + mean
        kernels = _blur_kernels(_uniform(key, "blur", (b,), 0.0, 1.0, dev) > 0.5, _uniform(key, "sigma", (b,), 0.1, 2.0, dev))
        images = _blur_with(images, kernels[start:stop])
        images = torch.clamp(images, 0.0, 1.0)

    if cutout:
        do_cut = u("cut_apply", ()) > 0.5
        cy_cx = u("cut_center", (2,), 0.1, 0.9)
        half = u("cut_half", (2,), 0.05, 0.125)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] / h
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] / w
        in_y = torch.abs(ys - cy_cx[:, 0][:, None, None]) < half[:, 0][:, None, None]
        in_x = torch.abs(xs - cy_cx[:, 1][:, None, None]) < half[:, 1][:, None, None]
        hole = (in_y & in_x & do_cut[:, None, None])[..., None]
        # in logical order: after the blur's ``torch.cat`` a batch's layout
        # looks channels-last from two rows up but not for one row
        fill = _row_mean(images.contiguous(), (start, stop, b))
        images = torch.where(hole, fill, images)
    return images
