"""Per-board grid-refinement diagnostics (card/CPU A-B tool): the
counterpart of ``scripts/debug_gridfix.py``.

Replays the engine's refine path (``engine._pipeline_core``) with the
gridfix internals exposed — the detected (offset, spacing) per axis, the
arbitration confidences of the original and the corrected board, the
chosen side and both candidate FENs — so that a device-dependent
arbitration flip (what ``tools/drift_gate.py`` guards) can be localized to
detection or to confidence with one run per device.  The two boards are
classified in two calls, as the engine's arbitrate tail does.

Usage:
  python -m chessvision_tpu_torch.tools.debug_gridfix [substring ...]   # the card
  CVTPU_DEBUG_CPU=1 python -m ...debug_gridfix …  (or --device cpu)    # the CPU
  python -m ...debug_gridfix --summary    # aggregate error counts over the
      test set for every arbitration variant (original / detect /
      board-level / per-square / oracle / soft blends)
  CVTPU_DEBUG_DUMP=FILE also writes each board's gap, errors and blended
  FENs with ``--summary``.

Prints one JSON line per matching test image (or one summary line).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch import engine as engine_mod
from chessvision_tpu_torch.chessboard import fen_to_labels, labels_to_fen
from chessvision_tpu_torch.ops import gridfix
from chessvision_tpu_torch.ops.color import hflip
from chessvision_tpu_torch.ops.quad import find_quadrangle_batch, scale_quadrangle
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.tools.make_fen_goldens import shape_groups
from chessvision_tpu_torch.utils import full_f32

# the summary's arbitration variants
MARGINS = [0.0, 0.001, 0.002, 0.005, 0.01]
TAUS = [0.001, 0.002, 0.005, 0.01, 0.02]
# gap quantization before the sigmoid (τ pinned at the shipping 0.01):
# buckets coarser than a cross-device wobble make w identical on both
# devices for boards that land in the same bucket
QUANTS = [0.002, 0.004, 0.008]


def mask_quads(engine: Any, images: np.ndarray, threshold: float = 0.5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The engine's front half on a (B, H, W, 3) uint8 batch on its device,
    as ``engine._pipeline_core`` runs it: (float32 gray (B, H, W), the quads
    to warp (B, 4, 2), found (B,)); a board not found warps the identity.
    Call under ``torch.inference_mode`` and ``full_f32``."""
    comp, gray = engine_mod.preprocess_images(torch.as_tensor(images).to(engine.device))
    h = gray.shape[1]
    seg_logits = engine._extractor(comp.float() / 255.0)[..., 0].float()
    quad, found = find_quadrangle_batch(torch.sigmoid(seg_logits), float(threshold))
    quad_scaled = scale_quadrangle(quad, float(h), constants.INPUT_SIZE[1])
    dest = torch.from_numpy(engine_mod._DEST).to(engine.device)
    return gray.float(), torch.where(found[:, None, None], quad_scaled, dest), found


def replay(engine: Any, images: np.ndarray, threshold: float = 0.5) -> dict[str, np.ndarray]:
    """The refine path on a (B, H, W, 3) uint8 batch on ``engine``'s device:
    found, corr (B, 4), conf0, conf1 (B,) and the probabilities p0, p1
    (B, 64, 13) of the original and the corrected board."""
    with torch.inference_mode(), full_f32():
        gray, safe_quad, found = mask_quads(engine, images, threshold)
        b = gray.shape[0]
        # the margin-expanded warp, as engine._pipeline_core does it
        margin = engine_mod._REFINE_MARGIN
        bw, bh = constants.BOARD_SIZE
        dest_wide = torch.from_numpy(engine_mod._DEST).to(gray.device) + float(margin)
        ms_wide = get_perspective_transform(safe_quad, dest_wide.expand(b, 4, 2))
        wide = warp_perspective(gray, ms_wide, (bw + 2 * margin, bh + 2 * margin))
        boards0 = wide[:, margin : margin + bh, margin : margin + bw]
        rounded = torch.clamp(torch.floor(boards0 + 0.5), 0, 255)
        corr = gridfix.detect_grid(rounded)
        boards1 = gridfix.apply_correction(wide, corr, margin=margin)
        p0 = engine_mod._classify_squares(engine._classifier, engine._cls_probs_flag, hflip(boards0))
        p1 = engine_mod._classify_squares(engine._classifier, engine._cls_probs_flag, hflip(boards1))
        out = {
            "found": found,
            "corr": corr,
            "conf0": p0.amax(dim=-1).mean(dim=-1),
            "conf1": p1.amax(dim=-1).mean(dim=-1),
            "p0": p0,
            "p1": p1,
        }
        return {k: v.cpu().numpy() for k, v in out.items()}


def replay_items(engine: Any, items: Sequence[tuple[np.ndarray, str, str]]) -> list[dict[str, np.ndarray]]:
    """``replay`` over test items, one batch per native shape: one dict a
    board, in the items' order."""
    per_item: list[dict[str, np.ndarray]] = [{} for _ in items]
    for idxs in shape_groups(items).values():
        out = replay(engine, np.stack([items[i][0] for i in idxs]))
        for j, i in enumerate(idxs):
            per_item[i] = {k: v[j] for k, v in out.items()}
    return per_item


def fen_of(p: np.ndarray) -> str:
    """The validated FEN of one board's (64, 13) probabilities."""
    square_names = constants.SQUARE_NAMES_NORMAL
    validated, _ = engine_mod.validate_labels_batch(p[None], square_names)
    return labels_to_fen(validated[0], square_names)


def errors_of(fen: str, true_fen: str) -> int:
    return sum(a != b for a, b in zip(fen_to_labels(fen), fen_to_labels(true_fen)))


def records(per_item: list[dict], items: Sequence[tuple[np.ndarray, str, str]], backend: str) -> list[dict[str, Any]]:
    """One record a board: found, the correction, both confidences, the
    chosen side and both candidate FENs."""
    out = []
    for r, (_, name, true_fen) in zip(per_item, items):
        out.append({
            "backend": backend,
            "image": name,
            "found": bool(r["found"]),
            "corr": [round(float(v), 3) for v in r["corr"]],
            "conf0": round(float(r["conf0"]), 6),
            "conf1": round(float(r["conf1"]), 6),
            "chosen": "refined" if r["conf1"] > r["conf0"] else "original",
            "fen0": fen_of(r["p0"]),
            "fen1": fen_of(r["p1"]),
            "true_fen": true_fen,
        })
    return out


def summarize(
    per_item: list[dict], items: Sequence[tuple[np.ndarray, str, str]], backend: str
) -> tuple[dict[str, Any], dict[str, dict]]:
    """(the summary line: wrong squares over the set for every arbitration
    variant and the near ties that change a board's errors; the dump: each
    board's gap, errors and blended FENs)."""
    counts = {
        "original": 0,
        "detect": 0,
        "per_square": 0,
        "oracle_board": 0,
        **{f"board_margin_{m}": 0 for m in MARGINS},
        **{f"blend_tau_{t}": 0 for t in TAUS},
        **{f"blend_quant_{q}": 0 for q in QUANTS},
    }
    near_ties = []
    dump: dict[str, dict] = {}
    for r, (_, name, true_fen) in zip(per_item, items):
        e0 = errors_of(fen_of(r["p0"]), true_fen)
        e1 = errors_of(fen_of(r["p1"]), true_fen)
        counts["original"] += e0
        counts["detect"] += e1
        counts["oracle_board"] += min(e0, e1)
        for m in MARGINS:
            counts[f"board_margin_{m}"] += e1 if r["conf1"] > r["conf0"] + m else e0
        sq_use_1 = r["p1"].max(axis=-1) > r["p0"].max(axis=-1)  # (64,)
        mixed = np.where(sq_use_1[:, None], r["p1"], r["p0"])
        counts["per_square"] += errors_of(fen_of(mixed), true_fen)
        gap = float(r["conf1"] - r["conf0"])
        dump[name] = {"gap": round(gap, 6), "e0": e0, "e1": e1}
        for t in TAUS:
            w = 1.0 / (1.0 + np.exp(-gap / t))
            fen_b = fen_of(w * r["p1"] + (1.0 - w) * r["p0"])
            counts[f"blend_tau_{t}"] += errors_of(fen_b, true_fen)
            dump[name][f"fen_blend_{t}"] = fen_b
        for q in QUANTS:
            gq = np.round(gap / q) * q
            w = 1.0 / (1.0 + np.exp(-gq / 0.01))
            fen_q = fen_of(w * r["p1"] + (1.0 - w) * r["p0"])
            counts[f"blend_quant_{q}"] += errors_of(fen_q, true_fen)
            dump[name][f"fen_quant_{q}"] = fen_q
        if abs(gap) < 0.005 and e0 != e1:
            near_ties.append({"image": name[:8], "gap": round(gap, 5), "e0": e0, "e1": e1})
    summary = {
        "backend": backend,
        "images": len(items),
        "wrong_squares": counts,
        "near_ties_with_consequence": near_ties,
    }
    return summary, dump


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Per-board grid-refinement diagnostics (card/CPU A-B)")
    ap.add_argument("wanted", nargs="*", help="substrings of the test images to replay (default: all)")
    ap.add_argument("--summary", action="store_true", help="one line of error counts per arbitration variant")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; CVTPU_DEBUG_CPU=1 also picks the CPU")
    ap.add_argument("--test-root", default=None, help="test batches root (default: <data root>/test)")
    args = ap.parse_args(argv)
    device = "cpu" if os.getenv("CVTPU_DEBUG_CPU") else args.device

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval.evaluate import get_test_generator

    items = [
        it
        for it in get_test_generator(Path(args.test_root) if args.test_root else None)
        if not args.wanted or any(w in it[1] for w in args.wanted)
    ]
    if not items:
        print("no matching test images", file=sys.stderr)
        return 1
    cv = ChessVision(lazy_load=False, device=device)
    per_item = replay_items(cv.engine, items)
    backend = cv.engine.device.type
    if not args.summary:
        for rec in records(per_item, items, backend):
            print(json.dumps(rec))
        return 0
    summary, dump = summarize(per_item, items, backend)
    out_path = os.getenv("CVTPU_DEBUG_DUMP")
    if out_path:
        Path(out_path).write_text(json.dumps(dump, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
