"""The reference image→FEN pipeline, in plain float32 PyTorch and numpy.

``Reference(config, root, device)`` loads the configuration's checkpoints
with its own loader, or takes the seeded leaves the benchmark made.  ``segment`` gives the segmentation logits of uint8 BGR
frames; ``follow`` runs every later stage from given logits (mask,
quadrangle, homographies, the margin canvas warp, grid detection and
correction, both classifier passes and their blend), so that the stages
after the discontinuous threshold can be held to the program's own
logits; ``run`` is both, the whole pipeline from the frames.
``validate`` and ``fens`` are the host's chess rules and FEN strings.

Matmuls and convolutions run with TF32 off.  Imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from benchmark.reference import models, ops

ARBITRATE_TAU = 0.01
MISSING_KING_FLOOR = 0.05
LABELS = ["B", "K", "N", "P", "Q", "R", "b", "k", "n", "p", "q", "r", "f"]
_FILES, _RANKS = "abcdefgh", "12345678"
SQUARE_INDEX = {f + r: i for i, (r, f) in enumerate((r, f) for r in _RANKS for f in _FILES)}
SQUARES_NORMAL = [f + r for r in reversed(_RANKS) for f in _FILES]
SQUARES_FLIPPED = [f + r for r in _RANKS for f in reversed(_FILES)]
BACK_RANKS = {f + r for r in "18" for f in _FILES}


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions, no autograd."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The plain pipeline of one configuration (``configs/<name>.json``)."""

    def __init__(self, config: dict, root: Path, device: torch.device, precision: str = "fp32",
                 seeded: dict[str, dict[str, np.ndarray]] | None = None) -> None:
        self.config = config
        self.device = device
        ex, cl = config["models"]["extractor"], config["models"]["classifier"]

        def leaves(kind: str, model: dict) -> dict[str, np.ndarray]:
            return seeded[kind] if model["weights"] == "seeded" else models.load_npz(root / model["weights"])[0]

        self.ex = models.Layers(leaves("extractor", ex), device, precision)
        self.cl = models.Layers(leaves("classifier", cl), device, precision)
        self.ex_fn = models.arch(ex["model_id"]).forward
        self.cl_fn = models.arch(cl["model_id"]).forward
        self.cl_probs = bool(cl["outputs_probabilities"])
        eng = config["engine"]
        self.threshold = float(eng["threshold"])
        self.margin = int(eng["refine_margin"])
        self.block = int(config["reference"]["block_boards"])

    def segment(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames on the device → (B, 256, 256) logits,
        ``reference.block_boards`` frames at a time."""
        with full_f32():
            outs = []
            for i in range(0, len(frames), self.block):
                comp = ops.round_u8(ops.resize_area(frames[i : i + self.block])).float()
                outs.append(self.ex_fn(self.ex, comp / 255.0))
            return torch.cat(outs)

    def classify(self, boards: torch.Tensor) -> torch.Tensor:
        """(N, 512, 512) flipped float boards → (N, 64, 13) probabilities."""
        out = self.cl_fn(self.cl, ops.squares(boards) / 255.0)
        probs = out if self.cl_probs else torch.softmax(out, dim=-1)
        return probs.reshape(len(boards), 64, 13).float()

    def follow(self, frames: torch.Tensor, logits: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every stage after the segmenter, from ``logits`` (B, 256, 256):
        ``found``, the mask quad ``quad0`` and corrected ``quad1`` in frame
        pixels, the output boards ``board0``/``board1`` (uint8, flipped),
        the arbitrate ``gap`` and the blended ``probs``.  The nominal board
        is side 0, the grid-corrected one side 1."""
        with full_f32():
            return self._follow(frames, logits.float())

    def _follow(self, frames: torch.Tensor, logits: torch.Tensor) -> dict[str, torch.Tensor]:
        # one request's boards at once: the small products (homographies,
        # corrected corners, grid comb) then have the program's shapes
        h, m = frames.shape[1], self.margin
        found, quad0, ms, ms_wide = self._geometry(logits, h)
        gray = ops.bgr_to_gray_u8(frames).float()
        wide = ops.warp_fused(gray, ops.invert_homography(ms_wide), 512 + 2 * m, 512 + 2 * m)
        del gray
        b0 = wide[:, m : m + 512, m : m + 512]
        corr = ops.detect_grid(torch.clamp(torch.floor(b0 + 0.5), 0, 255))
        b1 = ops.apply_correction(wide, corr, m)
        quad1 = ops.refined_quadrangle(ms, corr)
        p0 = self.classify(ops.hflip(b0))
        p1 = self.classify(ops.hflip(b1))
        gap = p1.amax(dim=-1).mean(dim=-1) - p0.amax(dim=-1).mean(dim=-1)
        wgt = torch.sigmoid(gap / ARBITRATE_TAU)[:, None, None]
        return {
            "found": found,
            "quad0": quad0,
            "quad1": quad1,
            "board0": ops.round_u8(ops.hflip(b0)),
            "board1": ops.round_u8(ops.hflip(b1)),
            "gap": gap,
            "probs": wgt * p1 + (1.0 - wgt) * p0,
        }

    def _geometry(self, logits: torch.Tensor, h: int) -> tuple[torch.Tensor, ...]:
        """found, the mask quad in frame pixels, and the homographies onto
        the board and onto the margin canvas (the identity quad's where no
        board was found)."""
        b, dev = logits.shape[0], logits.device
        quad, found = ops.find_quadrangles(torch.sigmoid(logits), self.threshold)
        quad0 = ops.scale_quadrangle(quad, h)
        dest = torch.tensor([[0.0, 0.0], [512.0, 0.0], [512.0, 512.0], [0.0, 512.0]], device=dev)
        safe = torch.where(found[:, None, None], quad0, dest)
        ms = ops.perspective_transform(safe, dest.expand(b, 4, 2))
        ms_wide = ops.perspective_transform(safe, (dest + float(self.margin)).expand(b, 4, 2))
        return found, quad0, ms, ms_wide

    def wide_homographies(self, frames: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """(B, 3, 3) homographies of the frames onto the margin canvas."""
        with full_f32():
            return self._geometry(logits.float(), frames.shape[1])[3]

    def run(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        """The whole pipeline from the frames, in the program's output
        layout: logits, found, quadrangle, board_image, probabilities."""
        logits = self.segment(frames)
        f = self.follow(frames, logits)
        use = (f["gap"] > 0)
        return {
            "logits": logits,
            "found": f["found"],
            "quadrangle": torch.where(use[:, None, None], f["quad1"], f["quad0"]),
            "board_image": torch.where(use[:, None, None], f["board1"], f["board0"]),
            "probabilities": f["probs"],
        }


def validate(probs: np.ndarray, names: list[str]) -> list[list[str]]:
    """Chess-rule validation of (B, 64, 13) probabilities: no pawn on a
    back rank; one king a colour (the most probable stays); a colour with
    no king promotes its most king-probable square above the floor,
    displacing neither the other king nor a square already fixed."""
    preds = np.argmax(probs, axis=-1)
    back = [i for i, n in enumerate(names) if n in BACK_RANKS]
    pawns = {LABELS.index("P"), LABELS.index("p")}
    kings = {LABELS.index("K"), LABELS.index("k")}
    out = []
    for bi in range(len(probs)):
        lab = [LABELS[int(p)] for p in preds[bi]]
        fixed: set[int] = set()
        for sq in back:
            if preds[bi, sq] in pawns:
                alt = next(int(a) for a in np.argsort(-probs[bi, sq]) if int(a) not in pawns)
                lab[sq] = LABELS[alt]
                fixed.add(sq)
        for king in ("K", "k"):
            ki = LABELS.index(king)
            claim = sorted((sq for sq in range(64) if lab[sq] == king), key=lambda sq: -float(probs[bi, sq, ki]))
            for sq in claim[1:]:
                banned = kings | (pawns if sq in back else set())
                alt = next(int(a) for a in np.argsort(-probs[bi, sq]) if int(a) not in banned)
                lab[sq] = LABELS[alt]
                fixed.add(sq)
        for king, other in (("K", "k"), ("k", "K")):
            ki = LABELS.index(king)
            if king in lab:
                continue
            for sq in map(int, np.argsort(-probs[bi, :, ki])):
                if float(probs[bi, sq, ki]) < MISSING_KING_FLOOR:
                    break
                if lab[sq] == other or sq in fixed:
                    continue
                lab[sq] = king
                break
        out.append(lab)
    return out


def fen(labels: list[str], names: list[str]) -> str:
    """Board FEN of 64 labels in ``names``' order ('f' empty)."""
    board: list[str | None] = [None] * 64
    for lab, name in zip(labels, names):
        if lab != "f":
            board[SQUARE_INDEX[name]] = lab
    rows = []
    for rank in range(7, -1, -1):
        row, empty = "", 0
        for file in range(8):
            sym = board[rank * 8 + file]
            if sym is None:
                empty += 1
                continue
            row += (str(empty) if empty else "") + sym
            empty = 0
        rows.append(row + (str(empty) if empty else ""))
    return "/".join(rows)


def fens(probs: np.ndarray, found: np.ndarray, flip: bool = False) -> list[str]:
    """Validated FENs of a batch; "" where no board was found."""
    names = SQUARES_FLIPPED if flip else SQUARES_NORMAL
    labels = validate(probs, names)
    return [fen(lab, names) if ok else "" for lab, ok in zip(labels, found)]
