"""Whether an image-to-FEN entry's outputs are right: the numbers compared
with the plain reference (each held to its limit in ``limits/<cell>.json``
by ``harness/check.verdict``).

For every retained request the reference, in float32 with TF32 off, works
from the same frames:

- ``seg_err``: the segmenter.  ‖program logits − reference logits‖ over
  ‖reference logits‖, both from the frames, pooled over every retained
  board.
- The mask threshold is discontinuous, so the stages after it are held
  to the program's own logits: the reference runs the quadrangle, the
  homographies, the warp, the grid detection and correction and both
  classifier passes from them.  Then
  - ``found_mismatch``: boards whose found flag differs (exact, limit 0);
  - ``quad_mismatch``: boards whose quadrangle is neither the reference's
    mask quadrangle nor its corrected one, bit for bit (limit 0);
  - ``board_mismatch``: pixels of the returned boards that differ from the
    reference's board of the side the quadrangle names (limit 0);
  - ``choice_gap``: where the program kept the other side than the
    reference's arbitration, the reference's confidence gap between the
    sides (0 where they agree);
  - ``prob_err``: ‖program probabilities − reference blend‖ over ‖reference
    blend‖, pooled.
- ``fen_mismatch``: boards whose FEN differs from the reference's chess
  rules and FEN strings applied to the program's own probabilities and
  found flags (exact, limit 0).

Everything the reference reads of the program is an output being judged;
it takes no weight, table or state of the program.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from benchmark.reference import pipeline as ref_pipeline

EXACT = ("found_mismatch", "quad_mismatch", "board_mismatch", "fen_mismatch")
ORDER = ("seg_err", "prob_err", "choice_gap") + EXACT


def control_outputs(ctrl: ref_pipeline.Reference, frames: torch.Tensor) -> dict[str, Any]:
    """The control's outputs of one request, in the layout the entries
    return: the reference of another precision put in the program's place."""
    out = {k: v.cpu().numpy() for k, v in ctrl.run(frames).items()}
    out["fens"] = ref_pipeline.fens(out["probabilities"].astype(np.float32), out["found"])
    return out


class Judge:
    """Accumulates the numbers over retained requests."""

    def __init__(self, reference: ref_pipeline.Reference) -> None:
        self.ref = reference
        self._seg: dict[int, torch.Tensor] = {}
        self.sq = {"seg_d": 0.0, "seg_r": 0.0, "prob_d": 0.0, "prob_r": 0.0}
        self.n = dict.fromkeys(ORDER, 0.0)

    def seg(self, key: int, frames: torch.Tensor) -> torch.Tensor:
        if key not in self._seg:
            self._seg[key] = self.ref.segment(frames)
        return self._seg[key]

    def add(self, key: int, frames: torch.Tensor, out: dict[str, Any]) -> dict[str, torch.Tensor]:
        """Judge one request's outputs ``out`` (host arrays) on ``frames``
        (its input on the device).  Returns the reference's stages."""
        dev = frames.device
        logits = torch.as_tensor(np.asarray(out["logits"], np.float32), device=dev)
        r_logits = self.seg(key, frames)
        self.sq["seg_d"] += float(((logits - r_logits) ** 2).sum())
        self.sq["seg_r"] += float((r_logits**2).sum())
        f = self.ref.follow(frames, logits)
        found = np.asarray(out["found"], bool)
        self.n["found_mismatch"] += int((found != f["found"].cpu().numpy()).sum())
        # a photo with no board found returns no quadrangle, board or
        # probabilities; a batch returns them for every frame
        if out.get("quadrangle") is not None:
            self._geometry(out, f, np.arange(len(found)))
        probs = out.get("probabilities")
        fens = ref_pipeline.fens(np.asarray(probs, np.float32), found) if probs is not None else [""] * len(found)
        self.n["fen_mismatch"] += sum(a != b for a, b in zip(out["fens"], fens))
        return f

    def _geometry(self, out: dict[str, Any], f: dict[str, torch.Tensor], rows: np.ndarray) -> None:
        q = np.asarray(out["quadrangle"], np.float32)
        q0, q1 = f["quad0"].cpu().numpy()[rows], f["quad1"].cpu().numpy()[rows]
        gap = f["gap"].cpu().numpy()[rows]
        side1 = np.all(q == q1, axis=(1, 2))
        side0 = np.all(q == q0, axis=(1, 2))
        self.n["quad_mismatch"] += int((~(side0 | side1)).sum())
        boards = np.asarray(out["board_image"])
        b0, b1 = f["board0"].cpu().numpy()[rows], f["board1"].cpu().numpy()[rows]
        for k in range(len(rows)):
            if side0[k] and side1[k]:  # one quadrangle: the board says which side
                s1 = np.count_nonzero(boards[k] != b1[k]) < np.count_nonzero(boards[k] != b0[k])
            else:
                s1 = bool(side1[k])
            self.n["board_mismatch"] += int(np.count_nonzero(boards[k] != (b1[k] if s1 else b0[k])))
            if s1 != bool(gap[k] > 0):
                self.n["choice_gap"] = max(self.n["choice_gap"], float(abs(gap[k])))
        p = torch.as_tensor(np.asarray(out["probabilities"], np.float32)).to(f["probs"].device)
        pr = f["probs"][torch.as_tensor(rows, device=f["probs"].device)]
        self.sq["prob_d"] += float(((p - pr) ** 2).sum())
        self.sq["prob_r"] += float((pr**2).sum())

    def readings(self) -> dict[str, float]:
        r = dict(self.n)
        r["seg_err"] = float(np.sqrt(self.sq["seg_d"] / max(self.sq["seg_r"], 1e-30)))
        r["prob_err"] = float(np.sqrt(self.sq["prob_d"] / max(self.sq["prob_r"], 1e-30)))
        return {k: r[k] for k in ORDER}
