"""The engine's FENs over the test set on the CPU, as goldens: the
counterpart of ``scripts/make_fen_goldens.py``.

The goldens pin what the engine outputs (not ground truth) for every test
image; ``tools/drift_gate.py`` holds the card's FENs to them within a band.
They are made on the CPU by design: CPU goldens are what the gate compares
the card against.

Run: python -m chessvision_tpu_torch.tools.make_fen_goldens
     [--test-root DIR] [--out tests/goldens/fen_goldens_torch.json]

The default ``--out`` is the port's own file, never the JAX package's
committed ``tests/goldens/fen_goldens.json``.  Also here: the runner the
test-set tools share (``engine_fens``: grouped by native shape, chunks of
``CHUNK`` with the tail padded by its last frame).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
OUT = REPO / "tests" / "goldens" / "fen_goldens_torch.json"

# one batch shape per image shape, as the JAX script compiles one program
CHUNK = 8

Item = tuple[np.ndarray, str, str]  # (BGR image, file name, true FEN)


def shape_groups(items: Sequence[Item]) -> dict[tuple, list[int]]:
    """Indices of ``items`` grouped by native image shape, in first-seen
    order (a mixed-resolution test set cannot share one stacked batch)."""
    groups: dict[tuple, list[int]] = {}
    for idx, it in enumerate(items):
        groups.setdefault(it[0].shape, []).append(idx)
    return groups


def check_unique_names(items: Sequence[Item]) -> None:
    """Goldens key by bare file name: a name in two test batches would
    overwrite a record, so refuse it."""
    names = [name for _, name, _ in items]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise SystemExit(
            f"duplicate test image names across batches: {sorted(dupes)} — "
            "extend the golden keying (batch/name) before regenerating"
        )


def engine_fens(cv: Any, items: Sequence[Item], chunk: int = CHUNK, progress: bool = False) -> dict[str, dict]:
    """{file name: {"found", "fen"}} from ``cv.engine.process_batch`` over
    ``items``, by shape group in chunks of ``chunk``, the tail padded with
    its last frame."""
    results: dict[str, dict] = {}
    done = 0
    for idxs in shape_groups(items).values():
        for start in range(0, len(idxs), chunk):
            part = [items[i] for i in idxs[start : start + chunk]]
            batch = np.stack([img for img, _, _ in part])
            real = len(part)
            if real < chunk:
                batch = np.concatenate([batch, np.repeat(batch[-1:], chunk - real, axis=0)])
            res = cv.engine.process_batch(batch)
            for i, (_, name, _) in enumerate(part):
                results[name] = {"found": bool(res.board_found[i]), "fen": res.fens[i]}
            done += real
            if progress:
                print(f"  {done}/{len(items)}", flush=True)
    return results


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="The port's engine FENs over the test set on the CPU, as goldens")
    ap.add_argument("--test-root", default=None, help="test batches root (default: <data root>/test)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.eval.evaluate import get_test_generator

    items = list(get_test_generator(Path(args.test_root) if args.test_root else None))
    check_unique_names(items)
    cv = ChessVision(lazy_load=False, device="cpu")
    goldens = {
        "platform": "cpu",
        "note": "engine output FENs (not ground truth); regenerate with "
        "python -m chessvision_tpu_torch.tools.make_fen_goldens",
        "results": engine_fens(cv, items, progress=True),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(goldens, indent=1, sort_keys=True) + "\n")
    n_found = sum(r["found"] for r in goldens["results"].values())
    print(f"wrote {out} ({len(items)} images, {n_found} extracted)")


if __name__ == "__main__":
    main()
