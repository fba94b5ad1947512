"""One run of one benchmark cell of the PyTorch/CUDA port on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, makes its inputs from the seed, warms up
every shape the cell uses (all of it set-up), then with ``--trace 0``
drives the cell's entry point in a closed loop for ``--seconds`` and
reports the cell's end-to-end metrics; with ``--trace 1`` it profiles a
fixed slice of requests instead and reports the per-layer metrics.  Then
it checks what the timed path produced against the plain reference and
prints one JSON line last on standard output.  It exits non-zero, and
prints no result, without enough CUDA devices or if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """No ``CVTPU_*`` variable changes a cell; no library loads JAX; every
    build and kernel cache lies at a fixed path inside the checkout."""
    for key in [k for k in os.environ if k.startswith("CVTPU_")]:
        del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    from benchmark.harness import session

    result, check_lines = session.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                                      T_START)
    found = session.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(session.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
