"""Mine classifier training squares from the engine's own warps, the
counterpart of ``scripts/mine_warped_squares.py``.

Runs the port's batched engine over the board_extraction TRAIN images,
cuts the 64 warped squares of every found board (rank-major, as
``ops/squares.py``), keeps the squares the classifier labels with
confidence ≥ ``--min-conf`` and writes them as an ImageFolder in the
squares/ layout (13 class dirs, ``f`` = empty, ``_x`` = black pieces),
downsampling any class over ``--max-per-class``.

Fine-tune with:
    python -m chessvision_tpu_torch.train.train_classifier \\
        --extra-data store/datasets/warped_squares ...

Run: python -m chessvision_tpu_torch.tools.mine_warped_squares [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any

import numpy as np

from chessvision_tpu_torch import constants

REPO = Path(__file__).resolve().parent.parent.parent


def dir_name(label: str) -> str:
    """LABEL_NAMES entry → squares/ ImageFolder dir ('b' → '_b')."""
    return label if label in ("f",) or label.isupper() else "_" + label


def mine(cv: Any, images: np.ndarray, ids: list[str], min_conf: float = 0.955, chunk: int = 32) -> tuple[dict[str, list[tuple[str, np.ndarray]]], int]:
    """(label → [(file name, 64² crop)], boards found) over ``images``."""
    mined: dict[str, list[tuple[str, np.ndarray]]] = defaultdict(list)
    found_boards = 0
    for start in range(0, len(images), chunk):
        batch = images[start : start + chunk]
        real = len(batch)
        if real < chunk:
            batch = np.concatenate([batch, np.repeat(batch[-1:], chunk - real, axis=0)])
        res = cv.engine.process_batch(batch)
        probs = np.asarray(res.probabilities)
        boards = np.asarray(res.board_image)
        for bi in range(real):
            if not res.board_found[bi]:
                continue
            found_boards += 1
            stem = Path(ids[start + bi]).stem
            for sq in range(64):
                p = probs[bi, sq]
                if float(p.max()) < min_conf:
                    continue
                label = constants.LABEL_NAMES[int(p.argmax())]
                r, c = sq // 8, sq % 8
                mined[label].append((f"{stem}_{sq:02d}.png", boards[bi, r * 64 : (r + 1) * 64, c * 64 : (c + 1) * 64]))
        print(f"  {min(start + chunk, len(images))}/{len(images)}", file=sys.stderr, flush=True)
    return mined, found_boards


def write_image_folder(mined: dict[str, list[tuple[str, np.ndarray]]], out: Path, max_per_class: int, seed: int) -> dict[str, int]:
    import cv2

    rng = np.random.default_rng(seed)
    counts = {}
    for label, items in sorted(mined.items()):
        if len(items) > max_per_class:
            keep = rng.choice(len(items), max_per_class, replace=False)
            items = [items[i] for i in sorted(keep)]
        d = out / dir_name(label)
        d.mkdir(parents=True, exist_ok=True)
        for name, crop in items:
            cv2.imwrite(str(d / name), crop)
        counts[dir_name(label)] = len(items)
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Mine classifier squares from the engine's warps (PyTorch engine)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the arbitrate engine blends two classifier passes, which caps a
    # square's max probability near 0.98; 0.955 keeps the most confident
    # quarter
    ap.add_argument("--min-conf", type=float, default=0.955)
    ap.add_argument("--max-per-class", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=str(REPO / "store" / "datasets" / "warped_squares"))
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision
    from chessvision_tpu_torch.train import data as data_lib

    cv = ChessVision(lazy_load=False, device=args.device)
    data = data_lib.load_board_extraction()
    print(f"mining {len(data.train_images)} train boards", file=sys.stderr)
    mined, found = mine(cv, data.train_images, data.train_ids, args.min_conf, args.chunk)
    counts = write_image_folder(mined, Path(args.out), args.max_per_class, args.seed)
    print(f"boards used: {found}; squares written: {sum(counts.values())}")
    for k, v in sorted(counts.items()):
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
