"""Detailed walk through every pipeline stage of the PyTorch port, with
array statistics.

The counterpart of examples/detailed_example.py: per-stage shapes and
ranges, the extracted quadrangle, the top-3 predictions of the first
squares and the validation fixes, all from one batched
``Engine.process_batch`` call on the GPU (its result holds host numpy
arrays, as the JAX package's does).  The image is chosen as in
examples/torch_quickstart.py: the first test photo, else a seeded
synthetic one.

Run: python examples/torch_detailed_example.py [--device cpu] [--dtype float32] [--seed N]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chessvision_tpu_torch import BatchResult, ChessVision, constants  # noqa: E402
from chessvision_tpu_torch.synthetic import board_frames  # noqa: E402


def input_image(seed: int = 0) -> tuple[str, np.ndarray, bool]:
    """(name, BGR uint8 image, synthetic?): the first test photo, else the
    synthetic frame ``board_frames(seed, 1)``."""
    raw = Path(constants.DATA_ROOT) / "test" / "initial" / "raw"
    files = sorted(raw.glob("*.JPG"))
    if files:
        import cv2

        return files[0].name, cv2.imread(str(files[0])), False
    return f"synthetic.board_frames({seed}, 1)", board_frames(seed, 1)[0][0], True


def main(
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    *,
    seed: int = 0,
) -> BatchResult:
    name, image, synthetic = input_image(seed)
    if synthetic:
        print(f"no *.JPG under {constants.DATA_ROOT}/test/initial/raw: using the synthetic board photo {name}")
    print(f"Input image: {image.shape} {image.dtype}, range [{image.min()}, {image.max()}]")

    cv_model = ChessVision(lazy_load=False, device=device, dtype=dtype)
    result = cv_model.engine.process_batch(image[None])

    logits = result.logits[0]
    print(f"\nSegmentation logits: {logits.shape}, range [{logits.min():.2f}, {logits.max():.2f}]")
    mask = result.binary_mask[0]
    print(f"Binary mask: {mask.shape}, foreground {100 * (mask > 0).mean():.1f}%")

    if not result.board_found[0]:
        print("No board found")
        return result

    quad = result.quadrangle[0]
    print(f"Quadrangle (original-image coords):\n{np.round(quad, 1)}")
    board = result.board_image[0]
    print(f"Extracted board: {board.shape}, range [{board.min()}, {board.max()}]")

    probs = result.probabilities[0]  # (64, 13)
    print(f"\nClassifier probabilities: {probs.shape}")
    names = result.extra["square_names"]
    print("\nTop-3 per square (first 8 squares):")
    for sq in range(8):
        order = np.argsort(probs[sq])[::-1][:3]
        tops = ", ".join(f"{constants.LABEL_NAMES[i]}:{probs[sq, i]:.3f}" for i in order)
        print(f"  {names[sq]}: {tops}")

    print(f"\noriginal FEN: {result.original_fens[0]}")
    print(f"validated FEN: {result.fens[0]}")
    for fix in result.validation_fixes[0]:
        print(f"  fix: {fix.square_name} {fix.original_piece} -> {fix.corrected_piece} ({fix.rule_name})")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"), help="the models' convolutions")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic photo where no test photo exists")
    args = ap.parse_args()
    main(args.device, getattr(torch, args.dtype), seed=args.seed)
