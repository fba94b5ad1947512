"""A plain float32 YOLO11-seg board extractor in eager torch, for the tests
of the port's ``yolo11_seg``: no JAX, nothing of the port.

``PlainYolo11Seg(flat)`` holds the leaves of a flat Flax-layout dict
(``params/model/<i>/.../kernel`` (kh, kw, in / groups, out), ``scale``,
``bias``, ``batch_stats/.../mean`` and ``var``) and runs the model as
Ultralytics' modules compute it: every convolution, BatchNorm (eps 1e-3,
running statistics) and SiLU as separate ops, shortcuts added after the
activation, the attention as matmul, softmax, matmul.  ``head`` gives the
raw outputs (per level the box bins, class logits and coefficients, and
the prototypes); ``logits`` the extractor's contract logits of the top
detection's mask, through ``process_mask`` below, a literal transcription
of Ultralytics' ``ops.crop_mask`` and ``ops.process_mask`` (8.1–8.3).
``seeded_leaves`` draws a seeded value for every leaf of given shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

REG_MAX, STRIDES, NM, CONF = 16, (8, 16, 32), 32, 0.25
OFF_LOGIT, ON_LOGIT_MIN = -20.0, 2.0**-8


def seeded_leaves(shapes: dict[str, tuple[int, ...]], seed: int, gain: float = 2.0) -> dict[str, np.ndarray]:
    """Kernels N(0, gain / fan-in), BatchNorm scales and variances near 1,
    biases and means near 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape, leaf = shapes[name], name.rsplit("/", 1)[1]
        z = rng.standard_normal(shape).astype(np.float32)
        if leaf == "kernel":
            z *= math.sqrt(gain / math.prod(shape[:-1]))
        elif leaf == "var":
            z = 1.0 + 0.1 * np.abs(z)
        elif leaf == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        out[name] = z.astype(np.float32)
    return out


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Ultralytics ``ops.crop_mask``: zero every pixel of each (h, w) mask
    outside its box (x1, y1, x2, y2)."""
    _, h, w = masks.shape
    x1, y1, x2, y2 = torch.chunk(boxes[:, :, None], 4, 1)
    r = torch.arange(w, device=masks.device, dtype=x1.dtype)[None, None, :]
    c = torch.arange(h, device=masks.device, dtype=x1.dtype)[None, :, None]
    return masks * ((r >= x1) * (r < x2) * (c >= y1) * (c < y2))


def process_mask(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor, shape: tuple[int, int],
                 upsample: bool = False) -> torch.Tensor:
    """Ultralytics ``ops.process_mask``: (n, h, w) bool masks of the
    detections' coefficients ``masks_in`` (n, c) over ``protos`` (c, mh, mw),
    cropped to ``bboxes`` (n, 4) in input pixels of ``shape``."""
    c, mh, mw = protos.shape
    ih, iw = shape
    masks = (masks_in @ protos.float().view(c, -1)).view(-1, mh, mw)
    downsampled_bboxes = bboxes.clone()
    downsampled_bboxes[:, 0] *= mw / iw
    downsampled_bboxes[:, 2] *= mw / iw
    downsampled_bboxes[:, 3] *= mh / ih
    downsampled_bboxes[:, 1] *= mh / ih
    masks = crop_mask(masks, downsampled_bboxes)
    if upsample:
        masks = F.interpolate(masks[None], shape, mode="bilinear", align_corners=False)[0]
    return masks.gt_(0.0)


def upsampled_mask(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor,
                   shape: tuple[int, int]) -> torch.Tensor:
    """``process_mask(..., upsample=True)``'s map before its ``gt_(0.0)``."""
    c, mh, mw = protos.shape
    ratios = torch.tensor([mw / shape[1], mh / shape[0], mw / shape[1], mh / shape[0]])
    masks = crop_mask((masks_in @ protos.float().view(c, -1)).view(-1, mh, mw), bboxes * ratios)
    return F.interpolate(masks[None], shape, mode="bilinear", align_corners=False)[0]


def top_detection(levels: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each frame of the raw levels: the top anchor (argmax of the
    sigmoid scores, the first on ties), its score, its box (x1, y1, x2,
    y2) in input pixels and its coefficients."""
    b = levels[0].shape[0]
    pred = torch.cat([t.reshape(b, t.shape[1], -1) for t in levels], 2).float()
    nc = pred.shape[1] - 4 * REG_MAX - NM
    centres = []
    for t, s in zip(levels, STRIDES):
        h, w = t.shape[2:]
        for y in range(h):
            for x in range(w):
                centres.append(((x + 0.5) * s, (y + 0.5) * s, float(s)))
    scores = torch.sigmoid(pred[:, 4 * REG_MAX : 4 * REG_MAX + nc]).amax(1)
    top = torch.argmax(scores, dim=1)
    boxes, coeffs = [], []
    for i in range(b):
        a = int(top[i])
        p = torch.softmax(pred[i, : 4 * REG_MAX, a].reshape(4, REG_MAX), dim=-1)
        lt_rb = (p * torch.arange(REG_MAX, dtype=torch.float32)).sum(-1)
        ax, ay, s = centres[a]
        boxes.append(torch.stack([ax - lt_rb[0] * s, ay - lt_rb[1] * s, ax + lt_rb[2] * s, ay + lt_rb[3] * s]))
        coeffs.append(pred[i, 4 * REG_MAX + nc :, a])
    return top, scores[torch.arange(b), top], torch.stack(boxes), torch.stack(coeffs)


def contract_logits(levels: list[torch.Tensor], protos: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) logits: the top detection's upsampled mask where
    ``process_mask`` keeps a pixel (at least 2**-8), −20 elsewhere and in a
    frame whose top score is not over 0.25."""
    _, score, boxes, coeffs = top_detection(levels)
    out = torch.full((len(score), *shape), OFF_LOGIT)
    for i in range(len(score)):
        if float(score[i]) > CONF:
            keep = process_mask(protos[i], coeffs[i : i + 1], boxes[i : i + 1], shape, upsample=True)[0].bool()
            up = upsampled_mask(protos[i], coeffs[i : i + 1], boxes[i : i + 1], shape)[0]
            out[i] = torch.where(keep, up.clamp_min(ON_LOGIT_MIN), OFF_LOGIT)
    return out


class PlainYolo11Seg:
    """The plain model over a flat leaf dict."""

    def __init__(self, flat: dict[str, np.ndarray]) -> None:
        self.t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in flat.items()}
        # repeats: the Bottlenecks of layer 2
        self.n = len({k.split("/")[4] for k in self.t if k.startswith("params/model/2/m/")})

    def conv(self, x: torch.Tensor, path: str, stride: int = 1, groups: int = 1) -> torch.Tensor:
        w = self.t[f"params/{path}/kernel"]
        k = w.shape[0]
        return F.conv2d(x, w.permute(3, 2, 0, 1), self.t.get(f"params/{path}/bias"), stride, k // 2, 1, groups)

    def cbs(self, x: torch.Tensor, path: str, stride: int = 1, groups: int = 1, act: bool = True) -> torch.Tensor:
        """Ultralytics ``Conv``: convolution, BatchNorm, SiLU."""
        y = self.conv(x, f"{path}/conv", stride, groups)
        mean, var = self.t[f"batch_stats/{path}/bn/mean"], self.t[f"batch_stats/{path}/bn/var"]
        scale, bias = self.t[f"params/{path}/bn/scale"], self.t[f"params/{path}/bn/bias"]
        y = (y - mean[:, None, None]) * (torch.rsqrt(var + 1e-3) * scale)[:, None, None] + bias[:, None, None]
        return F.silu(y) if act else y

    def bottleneck(self, x: torch.Tensor, path: str) -> torch.Tensor:
        return x + self.cbs(self.cbs(x, f"{path}/cv1"), f"{path}/cv2")

    def c3k2(self, x: torch.Tensor, path: str, c3k: bool) -> torch.Tensor:
        y = list(self.cbs(x, f"{path}/cv1").chunk(2, 1))
        for i in range(self.n):
            p = f"{path}/m/{i}"
            if c3k:
                z = self.cbs(y[-1], f"{p}/cv1")
                for j in range(2):
                    z = self.bottleneck(z, f"{p}/m/{j}")
                y.append(self.cbs(torch.cat((z, self.cbs(y[-1], f"{p}/cv2")), 1), f"{p}/cv3"))
            else:
                y.append(self.bottleneck(y[-1], p))
        return self.cbs(torch.cat(y, 1), f"{path}/cv2")

    def attention(self, x: torch.Tensor, path: str) -> torch.Tensor:
        b, c, h, w = x.shape
        heads = c // 64
        qkv = self.cbs(x, f"{path}/qkv", act=False).view(b, heads, 32 + 32 + 64, h * w)
        q, k, v = qkv.split([32, 32, 64], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * 32**-0.5).softmax(dim=-1)
        y = (v @ attn.transpose(-2, -1)).view(b, c, h, w) + self.cbs(v.reshape(b, c, h, w), f"{path}/pe",
                                                                     groups=c, act=False)
        return self.cbs(y, f"{path}/proj", act=False)

    def features(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x[..., [2, 1, 0]].permute(0, 3, 1, 2).contiguous()
        x = self.cbs(self.cbs(x, "model/0", 2), "model/1", 2)
        p3b = self.c3k2(self.cbs(self.c3k2(x, "model/2", False), "model/3", 2), "model/4", False)
        p4b = self.c3k2(self.cbs(p3b, "model/5", 2), "model/6", True)
        x = self.c3k2(self.cbs(p4b, "model/7", 2), "model/8", True)
        y = [self.cbs(x, "model/9/cv1")]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        x = self.cbs(torch.cat(y, 1), "model/9/cv2")
        c = x.shape[1] // 2
        a, bb = self.cbs(x, "model/10/cv1").split((c, c), 1)
        for i in range(self.n):
            bb = bb + self.attention(bb, f"model/10/m/{i}/attn")
            bb = bb + self.cbs(self.cbs(bb, f"model/10/m/{i}/ffn/0"), f"model/10/m/{i}/ffn/1", act=False)
        p5b = self.cbs(torch.cat((a, bb), 1), "model/10/cv2")
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        h4 = self.c3k2(torch.cat((up(p5b), p4b), 1), "model/13", False)
        p3 = self.c3k2(torch.cat((up(h4), p3b), 1), "model/16", False)
        p4 = self.c3k2(torch.cat((self.cbs(p3, "model/17", 2), h4), 1), "model/19", False)
        p5 = self.c3k2(torch.cat((self.cbs(p4, "model/20", 2), p5b), 1), "model/22", True)
        return p3, p4, p5

    def head(self, x: torch.Tensor) -> dict:
        """(B, H, W, 3) BGR in [0, 1] → per level (B, 64 + nc + 32, h, w)
        ``levels`` and (B, 32, 2h3, 2w3) ``protos``."""
        feats = self.features(x)
        levels = []
        for i, f in enumerate(feats):
            box = self.conv(self.cbs(self.cbs(f, f"model/23/cv2/{i}/0"), f"model/23/cv2/{i}/1"), f"model/23/cv2/{i}/2")
            c = self.cbs(self.cbs(f, f"model/23/cv3/{i}/0/0", groups=f.shape[1]), f"model/23/cv3/{i}/0/1")
            c = self.cbs(self.cbs(c, f"model/23/cv3/{i}/1/0", groups=c.shape[1]), f"model/23/cv3/{i}/1/1")
            cls = self.conv(c, f"model/23/cv3/{i}/2")
            coef = self.conv(self.cbs(self.cbs(f, f"model/23/cv4/{i}/0"), f"model/23/cv4/{i}/1"), f"model/23/cv4/{i}/2")
            levels.append(torch.cat((box, cls, coef), 1))
        y = self.cbs(feats[0], "model/23/proto/cv1")
        k = self.t["params/model/23/proto/upsample/kernel"]  # (2, 2, in, out), spatially flipped against torch's
        y = F.conv_transpose2d(y, torch.flip(k, (0, 1)).permute(2, 3, 0, 1),
                               self.t["params/model/23/proto/upsample/bias"], stride=2)
        y = self.cbs(self.cbs(y, "model/23/proto/cv2"), "model/23/proto/cv3")
        return {"levels": levels, "protos": y}

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.head(x)
        return contract_logits(raw["levels"], raw["protos"], tuple(x.shape[1:3]))
