"""Per-square error analysis of the test set on the port's engine, the
counterpart of ``scripts/error_analysis.py``.

Runs the engine over every test image and breaks each wrong square down:
which square, true→predicted confusion, the model's confidence in its
error, whether validation fixed it; then aggregates confusions, square
colors, ranks and the boards with most errors.  Writes a JSON report and
prints a markdown summary.

Run: python -m chessvision_tpu_torch.tools.error_analysis [--device cpu]
     [--test-root DIR] [--out scripts/out/error_analysis_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Any, Iterable

import numpy as np

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.chessboard import fen_to_labels

REPO = Path(__file__).resolve().parent.parent.parent

# FEN-order index → algebraic square name (rank 8 first, file a first)
_FEN_SQUARES = [f"{'abcdefgh'[i % 8]}{8 - i // 8}" for i in range(64)]


def _failure_record(name: str, binary_mask: np.ndarray) -> dict[str, Any]:
    """The mask fragments of a board that was not found."""
    import cv2

    mask = (np.asarray(binary_mask) > 0).astype(np.uint8)
    n, _, stats, _ = cv2.connectedComponentsWithStats(mask)
    areas = sorted(stats[1:, cv2.CC_STAT_AREA].tolist(), reverse=True)
    return {
        "name": name,
        "mask_area_frac": float(mask.mean()),
        "num_components": int(n - 1),
        "largest_area_frac": areas[0] / mask.size if areas else 0.0,
        "top_areas": [int(a) for a in areas[:5]],
    }


def _board_errors(name: str, true_fen: str, raw_fen: str, val_fen: str, probs: np.ndarray) -> list[dict[str, Any]]:
    dark = constants.DARK_SQUARES
    true, raw_pred, val_pred = fen_to_labels(true_fen), fen_to_labels(raw_fen), fen_to_labels(val_fen)
    out: list[dict[str, Any]] = []
    for sq in range(64):
        if raw_pred[sq] == true[sq]:
            continue
        p = probs[sq]
        order = np.argsort(p)[::-1]
        true_idx = constants.LABEL_INDICES[true[sq]]
        out.append({
            "board": name,
            "square": _FEN_SQUARES[sq],
            "color": "dark" if _FEN_SQUARES[sq] in dark else "light",
            "true": true[sq],
            "pred": raw_pred[sq],
            "p_pred": round(float(p[order[0]]), 4),
            "p_true": round(float(p[true_idx]), 4),
            "true_rank": int(np.where(order == true_idx)[0][0]) + 1,
            "fixed_by_validation": val_pred[sq] == true[sq],
            "broken_by_validation": False,
        })
    for sq in range(64):  # validation can also break a correct square
        if raw_pred[sq] == true[sq] and val_pred[sq] != true[sq]:
            out.append({
                "board": name,
                "square": _FEN_SQUARES[sq],
                "color": "dark" if _FEN_SQUARES[sq] in dark else "light",
                "true": true[sq],
                "pred": val_pred[sq],
                "p_pred": None,
                "p_true": None,
                "true_rank": 1,
                "fixed_by_validation": False,
                "broken_by_validation": True,
            })
    return out


def analyze(cv: Any, items: Iterable[tuple[np.ndarray, str, str]], chunk: int = 8, platform: str = "cuda") -> dict[str, Any]:
    """The error report of ``cv.engine`` over (image, name, true FEN)
    items, batched by image shape in chunks padded to ``chunk``."""
    items = list(items)
    shape_groups: dict[tuple, list] = {}
    for it in items:
        shape_groups.setdefault(it[0].shape, []).append(it)
    boards: list[dict[str, Any]] = []
    errors: list[dict[str, Any]] = []
    failure: dict[str, Any] | None = None
    done = 0
    for group in shape_groups.values():
        for start in range(0, len(group), chunk):
            part = group[start : start + chunk]
            batch = np.stack([img for img, _, _ in part])
            real = len(part)
            if real < chunk:
                batch = np.concatenate([batch, np.repeat(batch[-1:], chunk - real, axis=0)])
            res = cv.engine.process_batch(batch)
            for i, (_, name, true_fen) in enumerate(part):
                if not res.board_found[i]:
                    failure = _failure_record(name, res.binary_mask[i])
                    boards.append({"name": name, "errors": 64, "found": False})
                    continue
                b_errors = _board_errors(name, true_fen, res.original_fens[i], res.fens[i], np.asarray(res.probabilities[i]))
                errors.extend(b_errors)
                boards.append({"name": name, "errors": len(b_errors), "found": True})
            done += real
            print(f"  {done}/{len(items)}", file=sys.stderr, flush=True)

    confusions = Counter((e["true"], e["pred"]) for e in errors if not e["broken_by_validation"])
    return {
        "platform": platform,
        "num_boards": len(items),
        "total_errors": len(errors),
        "errors_fixed_by_validation": sum(1 for e in errors if e["fixed_by_validation"]),
        "errors_introduced_by_validation": sum(1 for e in errors if e["broken_by_validation"]),
        "top2_near_misses": sum(1 for e in errors if e.get("true_rank") == 2),
        "confusions": {f"{t}->{p}": c for (t, p), c in confusions.most_common()},
        "by_square_color": dict(Counter(e["color"] for e in errors)),
        "by_rank": dict(sorted(Counter(e["square"][1] for e in errors).items())),
        "by_true_label": dict(Counter(e["true"] for e in errors).most_common()),
        "boards_by_errors": sorted((b for b in boards if b["found"]), key=lambda b: -b["errors"])[:12],
        "extraction_failure": failure,
        "errors": errors,
    }


def print_summary(report: dict[str, Any]) -> None:
    n = report["num_boards"]
    broken = report["errors_introduced_by_validation"]
    raw = report["total_errors"] - broken
    print(f"\n## Error analysis ({report['platform']}, {n} boards)\n")
    print(f"- wrong squares (raw): {raw} ({raw / max(1, 64 * n):.2%} of all squares)")
    print(f"- fixed by validation: {report['errors_fixed_by_validation']}; broken by validation: {broken}")
    print(f"- top-2 near misses (true label ranked 2nd): {report['top2_near_misses']}")
    print("\ntop confusions (true→pred):")
    for key, c in list(report["confusions"].items())[:10]:
        t, p = key.split("->")
        print(f"  {t or 'empty':>5} → {p or 'empty':<5} ×{c}")
    print(f"\nby square color: {report['by_square_color']}")
    print(f"by rank: {report['by_rank']}")
    print("\nboards with most errors:")
    for b in report["boards_by_errors"][:8]:
        print(f"  {b['name']}: {b['errors']}")
    if report["extraction_failure"]:
        print(f"\nextraction failure: {json.dumps(report['extraction_failure'])}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Per-square error analysis of the test set (PyTorch engine)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--test-root", default=None, help="test batches root (default: <data root>/test)")
    ap.add_argument("--out", default=str(REPO / "scripts" / "out" / "error_analysis_torch.json"))
    ap.add_argument("--board-extractor-weights", default=None, help="analyze a candidate instead of the promoted weights")
    ap.add_argument("--classifier-weights", default=None)
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval.evaluate import get_test_generator

    cv = ChessVision(
        board_extractor_weights=args.board_extractor_weights,
        classifier_weights=args.classifier_weights,
        lazy_load=False,
        device=args.device,
    )
    items = get_test_generator(Path(args.test_root) if args.test_root else None)
    report = analyze(cv, items, args.chunk, platform=str(cv.device))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print_summary(report)


if __name__ == "__main__":
    main()
