"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import session

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

REHEARSAL = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark.harness import session, spec
from benchmark import calibrate
cell = spec.load_cell("unet32.photo12mp")
calibrate.shrink(cell)
cell.traffic["frames"]["count"] = 1
result, lines = session.run(cell, 3, 0.1, False, torch.device("cpu"), time.perf_counter())
assert result["correct"], lines
print("FOUND", ",".join(session.forbidden_modules()) or "-")
"""


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_forbidden_names_are_compared_whole():
    assert session.forbidden_modules(["chessvision_tpu_torch", "chessvision_tpu_torch.engine", "jaxtyping"]) == []
    found = session.forbidden_modules(["chessvision_tpu.engine", "flax.core", "jaxlib", "jax", "numpy"])
    assert found == ["chessvision_tpu", "flax", "jax", "jaxlib"]


def test_a_rehearsed_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(ROOT)], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND -"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py")) + sorted((BENCH / "counts").glob("*.py"))
    assert len(files) >= 6
    for path in files:
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"chessvision_tpu_torch", "chessvision_tpu", "jax", "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"chessvision_tpu", "jax", "jaxlib", "flax"}, path
