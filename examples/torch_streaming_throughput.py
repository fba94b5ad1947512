"""Throughput pattern of the PyTorch port: packed inputs and streamed
uploads on the GPU.

The counterpart of examples/streaming_throughput.py:

1. pack frames on the host with ``pack_inputs_yuv444`` (425 984 bytes a
   512² board against 786 432 for the raw frame, 1.85× fewer host→device
   bytes; rebuilt on the card bit-identical to the raw path where the
   chroma differences fit int8, as in board photos), and
2. feed the batches through ``Engine.run_stream(kind="yuv444")``, which
   uploads batch i+1 from pinned buffers on a copy stream while batch i
   computes.

The frames are the 512² test photos tiled to the batch size; where there
are none, one seeded synthetic board photo (``synthetic.board_frames``)
with its chroma pulled toward gray (``synthetic.limit_chroma``: the flat
clutter of the synthetic photos takes colors that the codec clips).  The
rate printed is boards/s from packing to FENs on the host, after a
warm-up, with the card synchronized before the clock stops.

Run: python examples/torch_streaming_throughput.py [n_batches] [batch_size] [--device cpu] [--dtype float32]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chessvision_tpu_torch import ChessVision, constants  # noqa: E402
from chessvision_tpu_torch.chessboard import labels_to_fen  # noqa: E402
from chessvision_tpu_torch.engine import pack_inputs_yuv444, validate_labels_batch  # noqa: E402
from chessvision_tpu_torch.synthetic import board_frames, limit_chroma  # noqa: E402


def input_frames(seed: int = 0) -> tuple[list[np.ndarray], bool]:
    """(512² BGR uint8 frames, synthetic?): the test photos of that size,
    else ``limit_chroma`` of the synthetic frame ``board_frames(seed, 1)``."""
    test_dir = Path(constants.DATA_ROOT) / "test" / "initial" / "raw"
    frames = []
    paths = sorted(test_dir.glob("*.JPG"))
    if paths:
        import cv2

        frames = [im for p in paths if (im := cv2.imread(str(p))) is not None and im.shape == (512, 512, 3)]
    if frames:
        return frames, False
    return [limit_chroma(board_frames(seed, 1)[0])[0]], True


def main(
    n_batches: int = 4,
    batch_size: int = 32,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> dict:
    """Stream ``n_batches`` batches; returns the batch streamed, each
    batch's FENs and found flags, and the rate."""
    frames, synthetic = input_frames(seed)
    if synthetic:
        print(f"no 512x512 *.JPG under {constants.DATA_ROOT}/test/initial/raw: using the synthetic board photo "
              f"limit_chroma(synthetic.board_frames({seed}, 1))")
    batch = np.stack((frames * ((batch_size // len(frames)) + 1))[:batch_size])

    engine = ChessVision(lazy_load=False, device=device, dtype=dtype).engine
    square_names = constants.SQUARE_NAMES_NORMAL

    def sync() -> None:
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    # host-side packing generator: in production the ingest threads (or the
    # native packers) run ahead of the card
    def packed_batches():
        for _ in range(n_batches):
            yield pack_inputs_yuv444(batch)

    # warm-up: cuDNN's algorithm choice, the kernels' first load, the
    # stream's pinned buffers
    for out in engine.run_stream([pack_inputs_yuv444(batch)], kind="yuv444"):
        out["found"].cpu()
    sync()

    t0 = time.perf_counter()
    fens: list[list[str]] = []
    found: list[np.ndarray] = []
    for out in engine.run_stream(packed_batches(), kind="yuv444"):
        probs = out["probabilities"].cpu().numpy()  # the copy back waits for this batch
        ok = out["found"].cpu().numpy()
        validated, _ = validate_labels_batch(probs, square_names)
        fens.append([labels_to_fen(validated[i], square_names) if ok[i] else "" for i in range(len(ok))])
        found.append(ok)
    sync()
    dt = time.perf_counter() - t0
    n_boards = sum(len(f) for f in fens)
    print(f"{n_boards} boards in {dt:.2f}s = {n_boards / dt:.1f} boards/s (streamed, yuv444, batch {batch_size})")
    print("sample FEN:", fens[0][0])
    return {"batch": batch, "fens": fens, "found": found, "seconds": dt, "boards_per_s": n_boards / dt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_batches", type=int, nargs="?", default=4)
    ap.add_argument("batch_size", type=int, nargs="?", default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"), help="the models' convolutions")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic photo where no test photo exists")
    args = ap.parse_args()
    main(args.n_batches, args.batch_size, device=args.device, dtype=getattr(torch, args.dtype), seed=args.seed)
