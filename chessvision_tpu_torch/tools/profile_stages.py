"""Per-stage timing of the pipeline on the card, the counterpart of
``scripts/profile_stages.py``.

Times each stage of the pipeline on its own, on inputs made on the device
from ``--seed`` (random frames, a soft sigmoid blob for the mask, fixed
quadrangles, a uniform board), each call ending in a synchronize; the
median of ``--iters`` calls.  ``homography_warp`` runs K1
(``ops/hat_resample.py:warp_twopass``).  ``fused_total`` is
``Engine.run_device`` on the same frames.

    python -m chessvision_tpu_torch.tools.profile_stages [--batch-size 128] [--iters 5] [--device cpu]

Prints one JSON line with each stage's median milliseconds and the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable

import numpy as np
import torch

from chessvision_tpu_torch import constants
from chessvision_tpu_torch.ops.color import bgr_to_gray, hflip
from chessvision_tpu_torch.ops.quad import find_quadrangle_batch
from chessvision_tpu_torch.ops.resize import resize
from chessvision_tpu_torch.ops.squares import extract_squares_batch
from chessvision_tpu_torch.ops.warp import get_perspective_transform, warp_perspective
from chessvision_tpu_torch.profiling import wall_ms
from chessvision_tpu_torch.tools import card
from chessvision_tpu_torch.utils import default_train_dtype, full_f32, resolve_device

# a board's corners in a 512² frame (x, y), as the JAX script fixes them
QUAD = [[60.0, 60.0], [450.0, 70.0], [460.0, 440.0], [50.0, 450.0]]
STAGES = ("resize_512_256", "grayscale", "unet_fwd", "quadrangle", "homography_warp", "squares_classifier")


def stage_inputs(bsz: int, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The stages' inputs, made on ``device`` from ``seed``: frames
    (B, 512, 512, 3) and the resized ones (B, 256, 256, 3) uint8, gray
    frames (B, 512, 512) uint8, a soft board mask (B, 256, 256), the fixed
    quadrangles (B, 4, 2) and boards (B, 512, 512) uniform in [0, 255)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u8(*shape: int) -> torch.Tensor:
        return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)

    line = torch.linspace(-1.0, 1.0, 256, device=device)
    blob = torch.sigmoid(8.0 * (0.6 - torch.maximum(line.abs()[:, None], line.abs()[None, :])))
    return {
        "images": u8(bsz, 512, 512, 3),
        "comp": u8(bsz, 256, 256, 3),
        "gray": u8(bsz, 512, 512),
        "probs": blob.expand(bsz, 256, 256),
        "quads": torch.tensor(QUAD, device=device).expand(bsz, 4, 2),
        "boards": torch.rand((bsz, 512, 512), generator=g, device=device) * 255.0,
    }


def stage_functions(cv: Any) -> dict[str, tuple[Callable[..., Any], tuple[str, ...]]]:
    """Each stage of ``cv``'s pipeline as a function, with the names of its
    ``stage_inputs``."""
    ex, _ = cv.board_extractor
    cl, _ = cv.classifier
    dest = torch.tensor([[0.0, 0.0], [512.0, 0.0], [512.0, 512.0], [0.0, 512.0]], device=cv.device)
    input_hw = (constants.INPUT_SIZE[1], constants.INPUT_SIZE[0])

    def resize_512_256(x: torch.Tensor) -> torch.Tensor:
        return resize(x, input_hw, round_uint8=True)

    def grayscale(x: torch.Tensor) -> torch.Tensor:
        return bgr_to_gray(x, exact_u8=True)

    def unet_fwd(c: torch.Tensor) -> torch.Tensor:
        return ex(c.float() / 255.0)[..., 0].float()

    def quadrangle(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return find_quadrangle_batch(p, 0.5)

    def homography_warp(gray: torch.Tensor, quads: torch.Tensor) -> torch.Tensor:
        ms = get_perspective_transform(quads, dest.expand(len(quads), 4, 2))
        return hflip(warp_perspective(gray.float(), ms, constants.BOARD_SIZE))

    def squares_classifier(boards: torch.Tensor) -> torch.Tensor:
        squares = extract_squares_batch(boards)
        return cl(squares.reshape(len(boards) * 64, *constants.PIECE_SIZE, 1) / 255.0)

    return {
        "resize_512_256": (resize_512_256, ("images",)),
        "grayscale": (grayscale, ("images",)),
        "unet_fwd": (unet_fwd, ("comp",)),
        "quadrangle": (quadrangle, ("probs",)),
        "homography_warp": (homography_warp, ("gray", "quads")),
        "squares_classifier": (squares_classifier, ("boards",)),
    }


def run(cv: Any, bsz: int, iters: int, seed: int) -> dict[str, Any]:
    """Median ms of each stage and of ``run_device`` at batch ``bsz``."""
    inputs = stage_inputs(bsz, seed, cv.device)
    results: dict[str, Any] = {}
    with torch.inference_mode(), full_f32():
        for name, (fn, keys) in stage_functions(cv).items():
            times = wall_ms(fn, *(inputs[k] for k in keys), iters=iters, warmup=1, device=cv.device)
            results[name] = round(float(np.median(times)), 2)
            print(f"{name}: {results[name]} ms", file=sys.stderr)
    times = wall_ms(lambda: cv.engine.run_device(inputs["images"])["found"].cpu(), iters=iters, warmup=1,
                    device=cv.device)
    results["fused_total"] = round(float(np.median(times)), 2)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Per-stage ms of the PyTorch port's pipeline (one JSON line)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from chessvision_tpu_torch.core import ChessVision

    dev = resolve_device(args.device)
    cv = ChessVision(lazy_load=False, device=dev, dtype=default_train_dtype(dev))
    results = run(cv, args.batch_size, args.iters, args.seed)
    results.update(batch_size=args.batch_size, backend=dev.type, **card.card_fields(dev))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
