"""The card's FENs held to CPU goldens within a band: the counterpart of
``scripts/tpu_drift_gate.py`` on a CUDA device.

The goldens are CPU FENs (``tools/make_fen_goldens.py``, or by default the
JAX package's committed ``tests/goldens/fen_goldens.json``, so that the
card is held to the reference's FENs).  bfloat16 convolutions on the card
legitimately move marginal pixels against the CPU; the gate fails when
more moves than the band allows, over every golden image:

  - found flags identical to the goldens;
  - per-board square diff ≤ ``max_square_diff`` for extracted boards;
  - ≥ ``min_exact`` boards with the exact golden FEN.

``MAX_SQUARE_DIFF`` / ``MIN_EXACT`` are the JAX gate's band for its 38 test
photos; another test set passes its own band to ``gate`` or ``compare``.
A test root whose image count differs from the goldens', or that holds no
image, fails: the gate never passes on nothing.

Exit codes: 0 pass, 1 drift (or a test set that does not match the
goldens), 42 no CUDA device (callers skip; the gate never runs on the CPU).
Run: python -m chessvision_tpu_torch.tools.drift_gate [--goldens FILE]
     [--test-root DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

import torch

from chessvision_tpu_torch.chessboard import fen_to_labels

REPO = Path(__file__).resolve().parent.parent.parent
GOLDENS = REPO / "tests" / "goldens" / "fen_goldens.json"
MAX_SQUARE_DIFF = 3
MIN_EXACT = 35
NO_CUDA = 42


def compare(
    got: dict[str, dict],
    goldens: dict[str, dict],
    max_square_diff: int = MAX_SQUARE_DIFF,
    min_exact: int = MIN_EXACT,
    backend: str = "cuda",
) -> dict[str, Any]:
    """The gate's summary of ``got`` ({name: {"found", "fen"}}) against
    ``goldens`` (the same records), in the goldens' order; ``backend``
    names where ``got`` ran, in the summary and its failure strings."""
    failures: list[str] = []
    exact = 0
    worst = 0
    for name, want in goldens.items():
        rec = got[name]
        if rec["found"] != want["found"]:
            failures.append(f"{name}: found flag drifted ({backend}={rec['found']}, golden={want['found']})")
            continue
        if not want["found"]:
            exact += 1  # both agree: no board
            continue
        if rec["fen"] == want["fen"]:
            exact += 1
            continue
        diff = sum(a != b for a, b in zip(fen_to_labels(rec["fen"]), fen_to_labels(want["fen"])))
        worst = max(worst, diff)
        if diff > max_square_diff:
            failures.append(
                f"{name}: {diff} squares differ from the CPU golden "
                f"(band is {max_square_diff}): {backend}={rec['fen']} golden={want['fen']}"
            )
    if exact < min_exact:
        failures.append(f"only {exact}/{len(goldens)} exact FEN matches (floor {min_exact})")
    return {
        "backend": backend,
        "images": len(goldens),
        "exact": exact,
        "worst_square_diff": worst,
        "failures": failures,
    }


def gate(
    goldens_path: str | Path = GOLDENS,
    test_root: str | Path | None = None,
    max_square_diff: int = MAX_SQUARE_DIFF,
    min_exact: int = MIN_EXACT,
    cv: Any = None,
) -> tuple[dict[str, Any], dict[str, dict]]:
    """Run ``cv``'s engine (default: the committed weights on the card)
    over the test set and compare it with the goldens: (summary, the FENs
    it got).  Raises ``SystemExit`` when the test set holds no image or
    another count of images than the goldens."""
    from chessvision_tpu_torch import constants
    from chessvision_tpu_torch.eval.evaluate import get_test_generator
    from chessvision_tpu_torch.tools.make_fen_goldens import engine_fens

    goldens = json.loads(Path(goldens_path).read_text())["results"]
    root = Path(test_root) if test_root else constants.data_root() / "test"
    if not root.is_dir():
        raise SystemExit(f"drift gate: no test set at {root}")
    items = list(get_test_generator(root))
    if not items or len(items) != len(goldens):
        raise SystemExit(f"drift gate: {len(items)} test images under {root} against {len(goldens)} goldens")
    if cv is None:
        from chessvision_tpu_torch.core import ChessVision

        cv = ChessVision(lazy_load=False, device="cuda")
    got = engine_fens(cv, items)
    return compare(got, goldens, max_square_diff, min_exact, backend=cv.engine.device.type), got


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Hold the card's FENs to CPU goldens within a band")
    ap.add_argument("--goldens", default=str(GOLDENS), help="CPU goldens (default: the JAX package's committed file)")
    ap.add_argument("--test-root", default=None, help="test batches root (default: <data root>/test)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(json.dumps({"skip": "no CUDA device (torch.cuda.is_available() is False)"}))
        return NO_CUDA

    from chessvision_tpu_torch.tools.card import card_fields

    summary, _ = gate(args.goldens, args.test_root)
    print(json.dumps({**summary, **card_fields("cuda")}))
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
