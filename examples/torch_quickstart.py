"""Quickstart of the PyTorch port: load a test image, run the full pipeline
on the GPU, print the FEN and write the comparison figure.

The counterpart of examples/quickstart.py.  The image is the first
``*.JPG`` under ``<data root>/test/initial/raw``; where that folder has
none, a seeded synthetic board photo (``synthetic.board_frames``), which
the first line of the output says.

Run: python examples/torch_quickstart.py [--device cpu] [--dtype float32] [--seed N] [--out PNG]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chessvision_tpu_torch import ChessVision, ChessVisionResult, constants  # noqa: E402
from chessvision_tpu_torch.eval.render import display_comparison  # noqa: E402
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
    out: str | Path | None = None,
) -> ChessVisionResult:
    name, image, synthetic = input_image(seed)
    if synthetic:
        print(f"no *.JPG under {constants.DATA_ROOT}/test/initial/raw: using the synthetic board photo {name}")
    print(f"Processing {name} ({image.shape})")

    cv_model = ChessVision(lazy_load=False, device=device, dtype=dtype)
    result = cv_model.process_image(image)

    if result.position is None:
        print("No chessboard detected")
    else:
        print(f"FEN:           {result.position.fen}")
        print(f"original FEN:  {result.position.original_fen}")
        print(f"fixes:         {result.position.validation_fixes}")
        print(f"time:          {result.processing_time * 1000:.1f} ms")

    # input / mask / board / predicted-position panels (the reference
    # notebook's display_comparison), drawn with cv2
    out = Path(out) if out is not None else Path(tempfile.gettempdir()) / "torch_quickstart_comparison.png"
    display_comparison(result, out, image=image)
    print(f"comparison:    {out}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"), help="the models' convolutions")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic photo where no test photo exists")
    ap.add_argument("--out", default=None, help="comparison PNG (default: in the temporary directory)")
    args = ap.parse_args()
    main(args.device, getattr(torch, args.dtype), seed=args.seed, out=args.out)
