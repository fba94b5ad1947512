"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` of the checkout, keyed on a hash of the source
and the flags, then loaded with ``ctypes``.  A library is built at first
use, never on import; ``build_all`` starts one ``nvcc`` per source at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the GPU")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed on source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, verbose: bool) -> tuple[Path, Path, subprocess.Popen] | None:
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(name: str, out: Path, tmp: Path, proc: subprocess.Popen, verbose: bool) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    if verbose and log:
        print(log, end="")
    os.replace(tmp, out)


def build_all(verbose: bool = False) -> list[str]:
    """Build every ``csrc/*.cu`` not yet built, all ``nvcc`` runs at once;
    returns the kernel names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: s for n in names if (s := _start_build(n, verbose)) is not None}
    for n, (out, tmp, proc) in started.items():
        _finish_build(n, out, tmp, proc, verbose)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        started = _start_build(name, verbose=False)
        if started is not None:
            _finish_build(name, *started, verbose=False)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
