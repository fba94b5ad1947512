"""YOLO11-seg as a board extractor (model id ``yolo11_seg``): Ultralytics'
``ultralytics/cfg/models/11/yolo11-seg.yaml`` with the modules of
``ultralytics/nn/modules/`` (``Conv``, ``DWConv``, ``C3k2``, ``C3k``,
``Bottleneck``, ``SPPF``, ``C2PSA``, ``PSABlock``, ``Attention``, ``Proto``,
``Detect``, ``Segment``), at a scale given by ``depth``, ``width`` and
``max_channels`` (s: 0.5, 0.5, 1024; n: 0.5, 0.25, 1024), and with the top
detection's mask as the extractor's logits.

The extractor contract: (B, 256, 256, 3) BGR in [0, 1] in (the engine's
input; the model reverses it to RGB, the order Ultralytics' predictor
feeds), (B, 256, 256, 1) float32 logits out, at a fixed shape and with no
host synchronisation.  The head runs on the device for every frame:

1. P3, P4 and P5 are flattened row-major, in that order, to A anchors;
2. DFL: a softmax over each side's 16 bins and ``Σ j·p_j`` gives
   (l, t, r, b); the anchor at ((x + 0.5)·s, (y + 0.5)·s) gives the box
   ``(ax − l·s, ay − t·s, ax + r·s, ay + b·s)``;
3. the score is ``sigmoid(cls)``, the detection ``argmax`` over anchors
   (the first on ties: the top box, NMS's first); the board is found iff
   its score is over ``CONF``;
4. its mask is Ultralytics' ``ops.process_mask(..., upsample=True)``
   (8.1–8.3): ``coeffs @ protos``, ``crop_mask`` with the box scaled to the
   prototypes (``x1 ≤ col < x2``, ``y1 ≤ row < y2``), a bilinear upsample
   (``align_corners=False``) to the input, positive where over 0.

The logits are that upsampled map where the mask holds (at least
``ON_LOGIT_MIN``, so the engine's sigmoid over 0.5 keeps exactly the
mask) and ``OFF_LOGIT`` everywhere else, and everywhere in a frame with no
detection.  ``profiling.span("seg_head")`` holds steps 1–4; in the engine
on the card everything before them is one CUDA graph replay
(``YOLO11Seg.capturable``).

Every BatchNorm (eps 1e-3, Ultralytics' ``initialize_weights``) runs
through ``BatchNorm2d.act`` in inference: the ``bn_act`` kernel with a SiLU
epilogue (``Conv(act=False)``: none), the Bottleneck's and the PSABlock's
shortcuts added in the same pass, after the activation.  Maps are stored
in the convolutions' dtype, but ``qkv`` (read by the float32 attention)
and the prototypes (read by the float32 mask product), which are float32.
Submodule names are Ultralytics' (``model.<i>...``), so its state dict
maps to this one but for the DFL's fixed ``arange`` convolution, which is
not a parameter here.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from chessvision_tpu_torch import profiling
from chessvision_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d, conv_dtype

REG_MAX = 16  # DFL bins a side
STRIDES = (8, 16, 32)  # P3, P4, P5
CONF = 0.25  # Ultralytics' default ``conf``: found iff the top score is over it
OFF_LOGIT = -20.0  # every pixel off the mask
ON_LOGIT_MIN = 2.0**-8  # the least logit of a mask pixel: its float32 sigmoid is over 0.5


def make_divisible(x: float) -> int:
    return math.ceil(x / 8) * 8


class Conv(nn.Module):
    """Bias-free convolution (``k // 2`` padding), BatchNorm, SiLU
    (``act=False``: none); ``residual`` is added after the activation."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True) -> None:
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3)
        self.silu = act

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        epi = ("silu+res" if residual is not None else "silu") if self.silu else "none"
        return self.bn.act(self.conv(x), epi, residual, out_dtype or conv_dtype(self.conv))


def DWConv(c1: int, c2: int, k: int = 1) -> Conv:  # noqa: N802 (Ultralytics' name)
    """Depthwise ``Conv``: ``gcd(c1, c2)`` groups."""
    return Conv(c1, c2, k, g=math.gcd(c1, c2))


class Bottleneck(nn.Module):
    """``x + cv2(cv1(x))``, two 3×3 ``Conv``s through ``c · e`` channels
    (``cv2`` ends in SiLU)."""

    def __init__(self, c: int, e: float = 0.5) -> None:
        super().__init__()
        self.cv1 = Conv(c, int(c * e), 3)
        self.cv2 = Conv(int(c * e), c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x), residual=x)


class C3k(nn.Module):
    """``cv3(cat(m(cv1 x), cv2 x))``, m two Bottlenecks at ``c / 2``
    channels; ``c`` in and out."""

    def __init__(self, c: int) -> None:
        super().__init__()
        c_ = c // 2
        self.cv1 = Conv(c, c_, 1)
        self.cv2 = Conv(c, c_, 1)
        self.cv3 = Conv(2 * c_, c, 1)
        self.m = nn.Sequential(Bottleneck(c_, e=1.0), Bottleneck(c_, e=1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    """C2f with C3k (``c3k``) or Bottleneck blocks: ``cv1``'s two halves,
    each block on the last piece, ``cv2`` over them all."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5) -> None:
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(C3k(self.c) if c3k else Bottleneck(self.c) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """``cv1``, three chained 5×5 stride-1 max pools, ``cv2`` over the four
    maps; ``c`` in and out."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.cv1 = Conv(c, c // 2, 1)
        self.cv2 = Conv(c // 2 * 4, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Multi-head self-attention over the map's pixels with a depthwise
    positional term: ``proj((v @ softmax(qᵀk · scale)ᵀ) + pe(v))``, keys
    half a head wide, the attention in float32; ``residual`` is added in
    ``proj``'s pass."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = self.head_dim // 2
        self.scale = self.key_dim**-0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self.qkv(x, out_dtype=torch.float32).reshape(b, self.num_heads, 2 * self.key_dim + self.head_dim, h * w)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).view(b, c, h, w)
        return self.proj(self.pe(v.reshape(b, c, h, w), residual=out), residual=residual)


class PSABlock(nn.Module):
    """``x + attn(x)``, then ``x + ffn(x)``."""

    def __init__(self, c: int, num_heads: int) -> None:
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x, residual=x)
        return self.ffn[1](self.ffn[0](x), residual=x)


class C2PSA(nn.Module):
    """``cv2(cat(a, m(b)))`` with (a, b) the halves of ``cv1``; ``c1``
    channels in and out, a head of 64 channels."""

    def __init__(self, c1: int, n: int = 1) -> None:
        super().__init__()
        self.c = c1 // 2
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, self.c // 64) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Proto(nn.Module):
    """Mask prototypes at twice P3's resolution, float32."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32) -> None:
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))), out_dtype=torch.float32)


class Segment(nn.Module):
    """Detect's box (``cv2``, 4·16 DFL bins) and class (``cv3``) branches,
    the mask coefficients (``cv4``) and the prototypes (``proto``); the
    top-1 mask assembled on the device (``assemble``)."""

    def __init__(self, nc: int, nm: int, npr: int, ch: tuple[int, ...]) -> None:
        super().__init__()
        self.nc, self.nm = nc, nm
        c2, c3 = max(16, ch[0] // 4, REG_MAX * 4), max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * REG_MAX, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                          nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)), Conv2d(c3, nc, 1)) for x in ch)
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nm, 1)) for x in ch)
        self._grids: dict = {}

    def head(self, feats: tuple[torch.Tensor, ...]) -> dict[str, torch.Tensor]:
        """The raw outputs: per level the (B, 4·16 + nc + nm, H, W) box
        bins, class logits and coefficients (``levels``), and the float32
        prototypes (``protos``, (B, nm, 2·H3, 2·W3))."""
        levels = [torch.cat((self.cv2[i](x), self.cv3[i](x), self.cv4[i](x)), 1) for i, x in enumerate(feats)]
        return {"levels": levels, "protos": self.proto(feats[0])}

    def _grid(self, levels: list[torch.Tensor], size: tuple[int, int], device: torch.device) -> torch.Tensor:
        """(A, 3) anchors (ax, ay, stride) in input pixels, made once a
        shape."""
        key = (tuple(t.shape[2:] for t in levels), size, device)
        if key not in self._grids:
            rows = []
            for t, s in zip(levels, STRIDES):
                h, w = t.shape[2:]
                ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                        indexing="ij")
                rows.append(torch.stack([(xs.flatten() + 0.5) * s, (ys.flatten() + 0.5) * s,
                                         torch.full((h * w,), float(s))], 1))
            self._grids[key] = torch.cat(rows).to(device)
        return self._grids[key]

    def assemble(self, raw: dict[str, torch.Tensor], size: tuple[int, int]) -> torch.Tensor:
        """(B, H, W, 1) float32 logits of the top detection's mask at the
        input's ``size`` (steps 1–4 of the module's docstring)."""
        levels, protos = raw["levels"], raw["protos"]
        b, nm, mh, mw = protos.shape
        ih, iw = size
        pred = torch.cat([t.flatten(2) for t in levels], 2).float()  # (B, 64 + nc + nm, A)
        scores = pred[:, 4 * REG_MAX : 4 * REG_MAX + self.nc].sigmoid().amax(1)
        top = scores.argmax(1)
        found = scores.gather(1, top[:, None])[:, 0] > CONF
        sel = pred.gather(2, top[:, None, None].expand(b, pred.shape[1], 1))[..., 0]
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=pred.device)
        dist = (sel[:, : 4 * REG_MAX].view(b, 4, REG_MAX).softmax(-1) * bins).sum(-1)
        anchor = self._grid(levels, size, pred.device)[top]  # (B, 3)
        ax, ay, s = anchor[:, 0], anchor[:, 1], anchor[:, 2]
        x1, y1 = ax - dist[:, 0] * s, ay - dist[:, 1] * s
        x2, y2 = ax + dist[:, 2] * s, ay + dist[:, 3] * s
        masks = torch.einsum("bc,bchw->bhw", sel[:, 4 * REG_MAX + self.nc :], protos)
        cols = torch.arange(mw, dtype=torch.float32, device=pred.device)[None, None, :]
        rows = torch.arange(mh, dtype=torch.float32, device=pred.device)[None, :, None]
        wr, hr = mw / iw, mh / ih

        def edge(t: torch.Tensor, ratio: float) -> torch.Tensor:
            return (t * ratio)[:, None, None]

        keep = (cols >= edge(x1, wr)) * (cols < edge(x2, wr)) * (rows >= edge(y1, hr)) * (rows < edge(y2, hr))
        up = F.interpolate((masks * keep)[:, None], size=(ih, iw), mode="bilinear", align_corners=False)[:, 0]
        on = (up > 0) & found[:, None, None]
        return torch.where(on, up.clamp_min(ON_LOGIT_MIN), OFF_LOGIT)[..., None]


def _up2(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2, mode="nearest")


class YOLO11Seg(nn.Module):
    """``yolo11-seg.yaml`` at (``depth``, ``width``, ``max_channels``) with
    ``nc`` classes; indices of ``model`` are the yaml's layers (the
    parameter-free upsample and concatenation layers are identities).

    The forward is ``finish(capturable(x), x)``: ``capturable`` is the
    network up to the head's raw outputs, fixed-shape device work that the
    engine replays as a CUDA graph on the card (``engine._GraphedExtractor``);
    ``finish`` is the decode, top-1 and mask (``cv:seg_head``)."""

    def __init__(self, depth: float = 0.5, width: float = 0.5, max_channels: int = 1024, nc: int = 1) -> None:
        super().__init__()

        def ch(c: int) -> int:
            return make_divisible(min(c, max_channels) * width)

        n = max(round(2 * depth), 1)  # every repeated layer of the yaml has 2
        layers: dict[int, nn.Module] = {
            0: Conv(3, ch(64), 3, 2),
            1: Conv(ch(64), ch(128), 3, 2),
            2: C3k2(ch(128), ch(256), n, False, 0.25),
            3: Conv(ch(256), ch(256), 3, 2),
            4: C3k2(ch(256), ch(512), n, False, 0.25),
            5: Conv(ch(512), ch(512), 3, 2),
            6: C3k2(ch(512), ch(512), n, True),
            7: Conv(ch(512), ch(1024), 3, 2),
            8: C3k2(ch(1024), ch(1024), n, True),
            9: SPPF(ch(1024)),
            10: C2PSA(ch(1024), n),
            13: C3k2(ch(1024) + ch(512), ch(512), n, False),
            16: C3k2(ch(512) + ch(512), ch(256), n, False),
            17: Conv(ch(256), ch(256), 3, 2),
            19: C3k2(ch(256) + ch(512), ch(512), n, False),
            20: Conv(ch(512), ch(512), 3, 2),
            22: C3k2(ch(512) + ch(1024), ch(1024), n, True),
            23: Segment(nc, 32, ch(256), (ch(256), ch(512), ch(1024))),
        }
        self.model = nn.ModuleList(layers.get(i, nn.Identity()) for i in range(24))

    def capturable(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """``Segment.head`` of an NHWC BGR input: the raw outputs."""
        return self.model[23].head(self._features(x))

    def finish(self, raw: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """The logits of the top detection's mask from the raw outputs of
        ``capturable(x)``."""
        with profiling.span("seg_head"):
            return self.model[23].assemble(raw, tuple(x.shape[1:3]))

    def _features(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        m = self.model
        x = x.flip(-1).permute(0, 3, 1, 2)  # BGR → RGB, NCHW (channels-last in memory)
        p3b = m[4](m[3](m[2](m[1](m[0](x)))))
        p4b = m[6](m[5](p3b))
        p5b = m[10](m[9](m[8](m[7](p4b))))
        h4 = m[13](torch.cat((_up2(p5b), p4b), 1))
        p3 = m[16](torch.cat((_up2(h4), p3b), 1))
        p4 = m[19](torch.cat((m[17](p3), h4), 1))
        p5 = m[22](torch.cat((m[20](p4), p5b), 1))
        return p3, p4, p5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.capturable(x), x)
