"""Ultralytics' YOLO11-seg as the port runs it (model id ``yolo11_seg``):
``yolo11-seg.yaml`` at (``depth``, ``width``, ``max_channels``) with ``nc``
classes, in plain float32, and the top detection's mask as the extractor's
logits.

Every convolution, the depthwise ones, the 1×1 heads and the prototypes'
transposed convolution go through ``L.conv`` / ``L.conv_transpose2x2``;
BatchNorm (eps 1e-3) through ``L.bn``, then SiLU (``act=False``: none);
shortcuts are added after the activation.  The attention is a matmul, a
softmax and a matmul.  The head: P3, P4, P5 flattened row-major to A
anchors; DFL (softmax over 16 bins, ``Σ j·p_j``) and the box
``(ax − l·s, ay − t·s, ax + r·s, ay + b·s)`` about the anchor
((x + 0.5)·s, (y + 0.5)·s); the score ``sigmoid(cls)``, the top anchor by
``argmax`` (first on ties), found iff its score is over 0.25; its mask as
Ultralytics' ``ops.process_mask(..., upsample=True)`` (8.1–8.3):
``coeffs @ protos``, ``crop_mask`` (``x1 ≤ col < x2``, ``y1 ≤ row < y2`` of
the box scaled to the prototypes), a bilinear upsample
(``align_corners=False``), positive over 0.  Logits: that map where the
mask holds (at least 2**-8) and −20 elsewhere and in a frame with no
detection.  The input is the engine's BGR, reversed to RGB first.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from benchmark.reference.models import Layers, bn_leaves

REG_MAX = 16
STRIDES = (8, 16, 32)
CONF = 0.25
OFF_LOGIT = -20.0
ON_LOGIT_MIN = 2.0**-8
NM = 32  # mask prototypes


def _widths(depth: float, width: float, max_channels: int) -> tuple:
    def ch(c: int) -> int:
        return math.ceil(min(c, max_channels) * width / 8) * 8

    return ch, max(round(2 * depth), 1)


# -- the forward -------------------------------------------------------------------


def _conv(L: Layers, x: torch.Tensor, path: str, k: int = 1, s: int = 1, g: int = 1, act: bool = True,
          residual: torch.Tensor | None = None) -> torch.Tensor:
    y = L.bn(L.conv(x, f"{path}/conv", s, k // 2, g), f"{path}/bn", 1e-3)
    if act:
        y = F.silu(y)
    return y if residual is None else y + residual.float()


def _bottleneck(L: Layers, x: torch.Tensor, path: str, add: bool) -> torch.Tensor:
    return _conv(L, _conv(L, x, f"{path}/cv1", 3), f"{path}/cv2", 3, residual=x if add else None)


def _c3k(L: Layers, x: torch.Tensor, path: str, n: int = 2) -> torch.Tensor:
    y = _conv(L, x, f"{path}/cv1")
    for i in range(n):
        y = _bottleneck(L, y, f"{path}/m/{i}", True)
    return _conv(L, torch.cat((y, _conv(L, x, f"{path}/cv2")), 1), f"{path}/cv3")


def _c3k2(L: Layers, x: torch.Tensor, path: str, n: int, c3k: bool) -> torch.Tensor:
    y = list(_conv(L, x, f"{path}/cv1").chunk(2, 1))
    for i in range(n):
        y.append(_c3k(L, y[-1], f"{path}/m/{i}") if c3k else _bottleneck(L, y[-1], f"{path}/m/{i}", True))
    return _conv(L, torch.cat(y, 1), f"{path}/cv2")


def _sppf(L: Layers, x: torch.Tensor, path: str) -> torch.Tensor:
    y = [_conv(L, x, f"{path}/cv1")]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, 1, 2))
    return _conv(L, torch.cat(y, 1), f"{path}/cv2")


def _attention(L: Layers, x: torch.Tensor, path: str, heads: int) -> torch.Tensor:
    b, c, h, w = x.shape
    hd = c // heads
    kd = hd // 2
    qkv = _conv(L, x, f"{path}/qkv", act=False).reshape(b, heads, 2 * kd + hd, h * w)
    q, k, v = qkv.split([kd, kd, hd], dim=2)
    attn = torch.softmax(torch.matmul(q.transpose(-2, -1), k) * kd**-0.5, dim=-1)
    out = torch.matmul(v, attn.transpose(-2, -1)).reshape(b, c, h, w)
    out = out + _conv(L, v.reshape(b, c, h, w), f"{path}/pe", 3, g=c, act=False)
    return _conv(L, out, f"{path}/proj", act=False)


def _c2psa(L: Layers, x: torch.Tensor, path: str, n: int) -> torch.Tensor:
    c = x.shape[1] // 2
    a, b = _conv(L, x, f"{path}/cv1").split((c, c), dim=1)
    for i in range(n):
        p = f"{path}/m/{i}"
        b = b + _attention(L, b, f"{p}/attn", c // 64)
        b = b + _conv(L, _conv(L, b, f"{p}/ffn/0"), f"{p}/ffn/1", act=False)
    return _conv(L, torch.cat((a, b), 1), f"{path}/cv2")


def _up2(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2, mode="nearest")


def _features(L: Layers, x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    x = x.flip(-1).permute(0, 3, 1, 2)
    x = _conv(L, _conv(L, x, "model/0", 3, 2), "model/1", 3, 2)
    p3b = _c3k2(L, _conv(L, _c3k2(L, x, "model/2", n, False), "model/3", 3, 2), "model/4", n, False)
    p4b = _c3k2(L, _conv(L, p3b, "model/5", 3, 2), "model/6", n, True)
    x = _sppf(L, _c3k2(L, _conv(L, p4b, "model/7", 3, 2), "model/8", n, True), "model/9")
    p5b = _c2psa(L, x, "model/10", n)
    h4 = _c3k2(L, torch.cat((_up2(p5b), p4b), 1), "model/13", n, False)
    p3 = _c3k2(L, torch.cat((_up2(h4), p3b), 1), "model/16", n, False)
    p4 = _c3k2(L, torch.cat((_conv(L, p3, "model/17", 3, 2), h4), 1), "model/19", n, False)
    p5 = _c3k2(L, torch.cat((_conv(L, p4, "model/20", 3, 2), p5b), 1), "model/22", n, True)
    return p3, p4, p5


def head(L: Layers, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The raw head outputs of (B, H, W, 3) BGR inputs in [0, 1]: per level
    the box bins, class logits and coefficients, (B, 64 + nc + 32, H, W)
    (``levels``), and the prototypes (``protos``)."""
    n = max(1, sum(1 for k in L.t if k.startswith("params/model/2/m/") and k.endswith("/cv1/conv/kernel")))
    feats = _features(L, x, n)
    levels = []
    for i, f in enumerate(feats):
        p = f"model/23/cv{{}}/{i}"
        box = L.conv(_conv(L, _conv(L, f, f"{p.format(2)}/0", 3), f"{p.format(2)}/1", 3), f"{p.format(2)}/2")
        c = _conv(L, _conv(L, f, f"{p.format(3)}/0/0", 3, g=f.shape[1]), f"{p.format(3)}/0/1")
        c = _conv(L, _conv(L, c, f"{p.format(3)}/1/0", 3, g=c.shape[1]), f"{p.format(3)}/1/1")
        cls = L.conv(c, f"{p.format(3)}/2")
        coef = L.conv(_conv(L, _conv(L, f, f"{p.format(4)}/0", 3), f"{p.format(4)}/1", 3), f"{p.format(4)}/2")
        levels.append(torch.cat((box, cls, coef), 1))
    y = _conv(L, feats[0], "model/23/proto/cv1", 3)
    y = _conv(L, L.conv_transpose2x2(y, "model/23/proto/upsample"), "model/23/proto/cv2", 3)
    return {"levels": levels, "protos": _conv(L, y, "model/23/proto/cv3")}


def assemble(levels: list[torch.Tensor], protos: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) logits of the top detection's mask."""
    b, _, mh, mw = protos.shape
    ih, iw = size
    pred = torch.cat([t.reshape(b, t.shape[1], -1) for t in levels], 2).float()
    nc = pred.shape[1] - 4 * REG_MAX - NM
    anchors = []
    for t, s in zip(levels, STRIDES):
        h, w = t.shape[2:]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        anchors.append(torch.stack([(xs.flatten() + 0.5) * s, (ys.flatten() + 0.5) * s,
                                    torch.full((h * w,), float(s))], 1))
    anchors = torch.cat(anchors).to(pred.device)
    out = torch.full((b, ih, iw), OFF_LOGIT, device=pred.device)
    for i in range(b):
        scores = torch.sigmoid(pred[i, 4 * REG_MAX : 4 * REG_MAX + nc]).amax(0)
        a = int(torch.argmax(scores))
        if not float(scores[a]) > CONF:
            continue
        bins = torch.softmax(pred[i, : 4 * REG_MAX, a].reshape(4, REG_MAX), dim=-1)
        l, t, r, bt = (bins * torch.arange(REG_MAX, dtype=torch.float32, device=pred.device)).sum(-1)
        ax, ay, s = anchors[a]
        box = torch.stack([ax - l * s, ay - t * s, ax + r * s, ay + bt * s])
        m = (pred[i, 4 * REG_MAX + nc :, a] @ protos[i].float().reshape(NM, -1)).reshape(mh, mw)
        x1, y1, x2, y2 = box * torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih], device=pred.device)
        cols = torch.arange(mw, dtype=torch.float32, device=pred.device)[None, :]
        rows = torch.arange(mh, dtype=torch.float32, device=pred.device)[:, None]
        m = m * ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2))
        up = F.interpolate(m[None, None], size=(ih, iw), mode="bilinear", align_corners=False)[0, 0]
        out[i] = torch.where(up > 0, up.clamp_min(ON_LOGIT_MIN), OFF_LOGIT)
    return out


def forward(L: Layers, x: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) BGR in [0, 1] → (B, 256, 256) logits."""
    raw = head(L, x)
    return assemble(raw["levels"], raw["protos"], tuple(x.shape[1:3]))


# -- the leaves -----------------------------------------------------------------------


def _conv_leaves(out: dict, path: str, c1: int, c2: int, k: int = 1, g: int = 1) -> None:
    out[f"params/{path}/conv/kernel"] = (k, k, c1 // g, c2)
    out.update(bn_leaves(f"{path}/bn", c2))


def _bottleneck_leaves(out: dict, path: str, c: int, e: float) -> None:
    _conv_leaves(out, f"{path}/cv1", c, int(c * e), 3)
    _conv_leaves(out, f"{path}/cv2", int(c * e), c, 3)


def _c3k2_leaves(out: dict, path: str, c1: int, c2: int, n: int, c3k: bool, e: float = 0.5) -> None:
    c = int(c2 * e)
    _conv_leaves(out, f"{path}/cv1", c1, 2 * c)
    _conv_leaves(out, f"{path}/cv2", (2 + n) * c, c2)
    for i in range(n):
        p = f"{path}/m/{i}"
        if c3k:
            c_ = c // 2
            _conv_leaves(out, f"{p}/cv1", c, c_)
            _conv_leaves(out, f"{p}/cv2", c, c_)
            _conv_leaves(out, f"{p}/cv3", 2 * c_, c)
            for j in range(2):
                _bottleneck_leaves(out, f"{p}/m/{j}", c_, 1.0)
        else:
            _bottleneck_leaves(out, p, c, 0.5)


def _final_leaves(out: dict, path: str, c1: int, c2: int) -> None:
    out[f"params/{path}/kernel"] = (1, 1, c1, c2)
    out[f"params/{path}/bias"] = (c2,)


def leaves(depth: float = 0.5, width: float = 0.5, max_channels: int = 1024, nc: int = 1) -> dict[str, tuple[int, ...]]:
    """Every leaf of ``forward`` with its shape (Flax layout)."""
    ch, n = _widths(depth, width, max_channels)
    out: dict[str, tuple[int, ...]] = {}
    _conv_leaves(out, "model/0", 3, ch(64), 3)
    _conv_leaves(out, "model/1", ch(64), ch(128), 3)
    _c3k2_leaves(out, "model/2", ch(128), ch(256), n, False, 0.25)
    _conv_leaves(out, "model/3", ch(256), ch(256), 3)
    _c3k2_leaves(out, "model/4", ch(256), ch(512), n, False, 0.25)
    _conv_leaves(out, "model/5", ch(512), ch(512), 3)
    _c3k2_leaves(out, "model/6", ch(512), ch(512), n, True)
    _conv_leaves(out, "model/7", ch(512), ch(1024), 3)
    _c3k2_leaves(out, "model/8", ch(1024), ch(1024), n, True)
    c5 = ch(1024)
    _conv_leaves(out, "model/9/cv1", c5, c5 // 2)
    _conv_leaves(out, "model/9/cv2", c5 // 2 * 4, c5)
    c = c5 // 2
    _conv_leaves(out, "model/10/cv1", c5, 2 * c)
    _conv_leaves(out, "model/10/cv2", 2 * c, c5)
    for i in range(n):
        p = f"model/10/m/{i}"
        kd = c // (c // 64) // 2
        _conv_leaves(out, f"{p}/attn/qkv", c, c + 2 * kd * (c // 64))
        _conv_leaves(out, f"{p}/attn/proj", c, c)
        _conv_leaves(out, f"{p}/attn/pe", c, c, 3, c)
        _conv_leaves(out, f"{p}/ffn/0", c, 2 * c)
        _conv_leaves(out, f"{p}/ffn/1", 2 * c, c)
    _c3k2_leaves(out, "model/13", c5 + ch(512), ch(512), n, False)
    _c3k2_leaves(out, "model/16", ch(512) + ch(512), ch(256), n, False)
    _conv_leaves(out, "model/17", ch(256), ch(256), 3)
    _c3k2_leaves(out, "model/19", ch(256) + ch(512), ch(512), n, False)
    _conv_leaves(out, "model/20", ch(512), ch(512), 3)
    _c3k2_leaves(out, "model/22", ch(512) + c5, c5, n, True)
    levels = (ch(256), ch(512), c5)
    c2, c3, c4 = max(16, levels[0] // 4, 4 * REG_MAX), max(levels[0], min(nc, 100)), max(levels[0] // 4, NM)
    for i, x in enumerate(levels):
        p = "model/23/cv{}/" + str(i)
        _conv_leaves(out, f"{p.format(2)}/0", x, c2, 3)
        _conv_leaves(out, f"{p.format(2)}/1", c2, c2, 3)
        _final_leaves(out, f"{p.format(2)}/2", c2, 4 * REG_MAX)
        _conv_leaves(out, f"{p.format(3)}/0/0", x, x, 3, x)
        _conv_leaves(out, f"{p.format(3)}/0/1", x, c3)
        _conv_leaves(out, f"{p.format(3)}/1/0", c3, c3, 3, c3)
        _conv_leaves(out, f"{p.format(3)}/1/1", c3, c3)
        _final_leaves(out, f"{p.format(3)}/2", c3, nc)
        _conv_leaves(out, f"{p.format(4)}/0", x, c4, 3)
        _conv_leaves(out, f"{p.format(4)}/1", c4, c4, 3)
        _final_leaves(out, f"{p.format(4)}/2", c4, NM)
    npr = ch(256)
    _conv_leaves(out, "model/23/proto/cv1", levels[0], npr, 3)
    out["params/model/23/proto/upsample/kernel"] = (2, 2, npr, npr)
    out["params/model/23/proto/upsample/bias"] = (npr,)
    _conv_leaves(out, "model/23/proto/cv2", npr, npr, 3)
    _conv_leaves(out, "model/23/proto/cv3", npr, NM)
    return out


# -- the bytes of bn_act ----------------------------------------------------------------

# a Bottleneck's last BatchNorm: in a C3k2 of Bottlenecks (layers 2, 4, 13,
# 16, 19), or inside a C3k (``m/<i>/m/<j>``); a C3k's own cv2 has none
_BOTTLENECK_CV2 = re.compile(r"^model/(2|4|13|16|19)/m/\d+/cv2/bn$|/m/\d+/m/\d+/cv2/bn$")
# BatchNorms whose output the port stores in float32: qkv (read by the
# float32 attention) and the prototypes (read by the float32 mask product)
_F32_OUT = ("/attn/qkv/bn", "model/23/proto/cv3/bn")


def bn_out_item(path: str, act: int) -> tuple[int, int]:
    """(output bytes an element, residual bytes an element) of the
    BatchNorm at ``path``: every map in the compute dtype but ``_F32_OUT``'s
    in float32; the Bottlenecks' and the PSABlock's shortcuts read a map in
    the compute dtype, ``pe``'s the float32 attention."""
    out = 4 if path.endswith(_F32_OUT) else act
    if path.endswith("/attn/pe/bn"):
        return out, 4
    return out, act if _BOTTLENECK_CV2.search(path) or path.endswith(("/attn/proj/bn", "/ffn/1/bn")) else 0
