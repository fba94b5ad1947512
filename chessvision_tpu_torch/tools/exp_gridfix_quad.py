"""Offline experiment: richer grid-detection families on the test boards,
the counterpart of ``scripts/exp_gridfix_quad.py``.

The shipped detector (``ops/gridfix.py``) proposes a per-axis AFFINE
correction (offset o, spacing s, lines at o + k·s, |o| ≤ 32 px).  Two
richer families:

  wide  — a mask that bleeds past the board by about a square needs a
          larger offset: |o| ≤ 56 px;
  quad  — a keystone (projective) residual varies the spacing across the
          board: lines at o + k·s + k²·q, |q| ≤ 2 px.

For every test board this classifies the board warped into 512² (no
margin), the shipped affine correction and each family's, and prints
per-board wrong-square counts, then set totals: each family alone and
soft-blend-arbitrated against the original (τ = 0.01).  The comb search
and the families' resample run in numpy on the host, as in the script;
the warp and the classifier on the engine's device.

Usage: python -m chessvision_tpu_torch.tools.exp_gridfix_quad
       [--device cpu] [--test-root DIR]
(the card by default; the JAX script defaults to the CPU.)
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import lru_cache
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.ops import gridfix
from chessvision_tpu_torch.ops.color import hflip
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.tools.debug_gridfix import errors_of, fen_of, mask_quads
from chessvision_tpu_torch.tools.make_fen_goldens import shape_groups
from chessvision_tpu_torch.utils import full_f32

B = gridfix.BOARD_SIZE
CELL = gridfix.CELL
VARIANTS = ["orig", "affine", "wide", "quad"]
FAMILY_NAMES = ("wide", "quad")
TAU = 0.01


def build_cand(off_max: float, q_vals: np.ndarray) -> np.ndarray:
    """(C, 3) candidates (o, s, q): offsets ±off_max by 0.5 px, spacings
    58–70 by 0.25 px, the given q."""
    offs = np.arange(-off_max, off_max + 0.5, 0.5, dtype=np.float32)
    sps = np.arange(58.0, 70.25, 0.25, dtype=np.float32)
    return np.array([(o, s, q) for o in offs for s in sps for q in q_vals], dtype=np.float32)


def build_comb(cand: np.ndarray) -> np.ndarray:
    """(C, 512) hat comb of each candidate's seven interior lines."""
    xs = np.arange(B, dtype=np.float32)
    k = np.arange(1, 8, dtype=np.float32)
    lines = cand[:, 0:1] + cand[:, 1:2] * k + cand[:, 2:3] * k * k  # (C, 7)
    w = np.zeros((len(cand), B), np.float32)
    for c0 in range(0, len(cand), 1024):
        sl = slice(c0, c0 + 1024)
        d = np.maximum(0.0, 1.0 - np.abs(xs[None, None, :] - lines[sl, :, None]))
        w[sl] = d.sum(axis=1)
    return w


@lru_cache(maxsize=1)
def families() -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """{family: (candidates, comb)}, built once a process (the quad comb is
    107 457 × 512 floats)."""
    cands = {
        "wide": build_cand(56.0, np.array([0.0], np.float32)),
        "quad": build_cand(32.0, np.arange(-2.0, 2.25, 0.25, dtype=np.float32)),
    }
    return {name: (c, build_comb(c)) for name, c in cands.items()}


def detect(rounded: torch.Tensor, name: str) -> np.ndarray:
    """The comb search of family ``name`` on (Bn, 512, 512) rounded boards:
    (Bn, 6) rows (ox, sx, qx, oy, sy, qy).  The profiles come from
    ``ops/gridfix`` on the boards' device, the search runs in numpy."""
    cand, comb = families()[name]
    p = gridfix._condition(gridfix._profiles(rounded)).cpu().numpy()  # (2Bn, 512)
    sel = cand[(p @ comb.T).argmax(axis=-1)]  # (2Bn, 3)
    bn = rounded.shape[0]
    return np.concatenate([sel[:bn], sel[bn:]], axis=1)


def resample_matrix(o: float, s: float, q: float) -> np.ndarray:
    u = np.arange(B, dtype=np.float32)
    t = u / CELL
    pos = o + t * s + t * t * q
    j = np.arange(B, dtype=np.float32)
    return np.maximum(0.0, 1.0 - np.abs(pos[:, None] - j[None, :]))


def apply_corr(boards_np: np.ndarray, corr: np.ndarray) -> np.ndarray:
    """Resample each board by its (ox, sx, qx, oy, sy, qy) row."""
    out = np.empty_like(boards_np)
    for i in range(boards_np.shape[0]):
        rx = resample_matrix(corr[i, 0], corr[i, 1], corr[i, 2])
        ry = resample_matrix(corr[i, 3], corr[i, 4], corr[i, 5])
        out[i] = ry @ boards_np[i] @ rx.T
    return out


def to_boards(engine: Any, images: np.ndarray, threshold: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """(boards0 (B, 512, 512) float32 on the device, found): the mask's
    quad warped into the 512² board, no margin."""
    with torch.inference_mode(), full_f32():
        gray, safe_quad, found = mask_quads(engine, images, threshold)
        dest = torch.from_numpy(engine_mod._DEST).to(gray.device)
        ms = get_perspective_transform(safe_quad, dest.expand(gray.shape[0], 4, 2))
        return warp_perspective(gray, ms, constants.BOARD_SIZE), found


def classify(engine: Any, boards: torch.Tensor) -> np.ndarray:
    """(N, 64, 13) probabilities of (N, 512, 512) boards (pre-flip)."""
    with torch.inference_mode(), full_f32():
        boards = torch.as_tensor(boards).to(engine.device)
        return engine_mod._classify_squares(engine._classifier, engine._cls_probs_flag, hflip(boards)).cpu().numpy()


def errs(p: np.ndarray, true_fen: str) -> int:
    return errors_of(fen_of(p), true_fen)


def run(engine: Any, items: Sequence[tuple[np.ndarray, str, str]]) -> tuple[list[dict], dict[str, int]]:
    """(per-board records, set totals) of the four variants over ``items``."""
    per_board: list[dict] = []
    for idxs in shape_groups(items).values():
        boards0, _ = to_boards(engine, np.stack([items[i][0] for i in idxs]))
        with torch.inference_mode(), full_f32():
            rounded = torch.clamp(torch.floor(boards0 + 0.5), 0, 255)
            cand_boards = {"orig": boards0}
            corr_aff = gridfix.detect_grid(rounded)
            cand_boards["affine"] = gridfix.apply_correction(boards0, corr_aff)
            det = {}
            boards0_np = boards0.cpu().numpy()
            for fam in FAMILY_NAMES:
                det[fam] = detect(rounded, fam)
                cand_boards[fam] = torch.from_numpy(apply_corr(boards0_np, det[fam]))
        probs = {v: classify(engine, cand_boards[v]) for v in VARIANTS}
        for j, i in enumerate(idxs):
            _, name, true_fen = items[i]
            rec: dict[str, Any] = {"image": name[:8], "true": true_fen}
            for v in VARIANTS:
                rec[f"e_{v}"] = errs(probs[v][j], true_fen)
                rec[f"c_{v}"] = float(probs[v][j].max(axis=-1).mean())
            for fam in FAMILY_NAMES:
                rec[f"corr_{fam}"] = [round(float(x), 2) for x in det[fam][j]]
            rec["p"] = {v: probs[v][j] for v in VARIANTS}
            per_board.append(rec)

    totals = {f"sum_{v}": 0 for v in VARIANTS}
    totals.update({f"blend_{v}": 0 for v in VARIANTS[1:]})
    totals["oracle_all"] = 0
    for rec in per_board:
        for v in VARIANTS:
            totals[f"sum_{v}"] += rec[f"e_{v}"]
        totals["oracle_all"] += min(rec[f"e_{v}"] for v in VARIANTS)
        p0 = rec["p"]["orig"]
        c0 = rec["c_orig"]
        for v in VARIANTS[1:]:
            gap = rec[f"c_{v}"] - c0
            w = 1.0 / (1.0 + np.exp(-gap / TAU))
            pb = w * rec["p"][v] + (1.0 - w) * p0
            totals[f"blend_{v}"] += errs(pb, rec["true"])
        del rec["p"]
    return per_board, totals


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Richer grid-detection families against the shipped affine one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--test-root", default=None, help="test batches root (default: <data root>/test)")
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval.evaluate import get_test_generator

    items = list(get_test_generator(Path(args.test_root) if args.test_root else None))
    cv = ChessVision(lazy_load=False, device=args.device)
    per_board, totals = run(cv.engine, items)
    for rec in sorted(per_board, key=lambda r: -r["e_affine"]):
        if max(rec[f"e_{v}"] for v in VARIANTS) > 0:
            print(json.dumps(rec))
    print(json.dumps({"backend": cv.engine.device.type, **totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
