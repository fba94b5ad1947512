"""End-to-end benchmark of the PyTorch port on the card: boards/s
image→FEN, the counterpart of ``bench.py``.  Prints one JSON line.

    python bench_torch.py [--batch-size 128] [--iters 6] [--quick] [--device cpu]

See ``chessvision_tpu_torch/tools/bench.py``."""

import sys

from chessvision_tpu_torch.tools.bench import main

if __name__ == "__main__":
    sys.exit(main())
