"""The port's launchers on the CPU: ``examples/torch_*.py`` and
``scripts/bin/torch_*.sh``.

- each example's ``main(device="cpu", dtype=torch.float32)`` on one
  synthetic frame prints the ``found`` flag and the FEN that the JAX
  facade gives at float32 on the same frame (the streaming example: two
  batches of two, every board's);
- the streaming example from its command line (``1 1 --device cpu``);
- without a GPU and without ``device="cpu"`` each example raises, as the
  facade does;
- each wrapper passes ``bash -n``; run with a recording stand-in for the
  interpreter (and for ``torchrun``), it calls a ``chessvision_tpu_torch``
  module with the JAX wrapper's defaults, and that module's ``main(argv)``
  accepts them and hands them to the function it drives.

Seed 1's synthetic frame is one on which the float32 models find a board,
so the FENs compared are not empty; the quickstart runs seed 0 as well,
where they find none.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessvision_tpu.core import ChessVision as JaxChessVision

REPO = Path(__file__).resolve().parent.parent
BIN = REPO / "scripts" / "bin"
WRAPPERS = [
    "evaluate",
    "serve",
    "train_board_extractor",
    "train_board_extractor_sweep",
    "train_classifier",
    "train_distributed",
    "train_yolo_board_extractor",
    "train_yolo_classifier",
]


def _example(name: str) -> ModuleType:
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    assert spec is not None and spec.loader is not None
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_facade():
    """(found, FEN) of the JAX facade at float32 on a frame (one compile)."""
    cv = JaxChessVision(dtype=jnp.float32)

    def run(image: np.ndarray) -> tuple[bool, str]:
        result = cv.process_image(image)
        return result.position is not None, result.position.fen if result.position else ""

    return run


# -- the examples ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_quickstart_prints_the_jax_facades_fen(jax_facade, capsys, tmp_path, seed) -> None:
    qs = _example("torch_quickstart")
    name, image, synthetic = qs.input_image(seed)
    out = tmp_path / "comparison.png"
    result = qs.main(device="cpu", dtype=torch.float32, seed=seed, out=out)
    lines = capsys.readouterr().out.splitlines()
    found, fen = jax_facade(image)
    assert (result.position is not None) == found
    if synthetic:
        assert "synthetic" in lines[0] and name in lines[0]
    if found:
        assert f"FEN:           {fen}" in lines
    else:
        assert "No chessboard detected" in lines
    assert out.is_file() and f"comparison:    {out}" in lines


def test_detailed_example_prints_the_jax_facades_fen(jax_facade, capsys) -> None:
    de = _example("torch_detailed_example")
    _, image, _ = de.input_image(1)
    result = de.main(device="cpu", dtype=torch.float32, seed=1)
    lines = capsys.readouterr().out.splitlines()
    found, fen = jax_facade(image)
    assert bool(result.board_found[0]) == found and found
    assert f"validated FEN: {fen}" in lines
    assert any(line.startswith("Segmentation logits: (256, 256)") for line in lines)
    assert sum(line.startswith("  ") and ":" in line for line in lines) >= 8  # the top-3 lines


def test_streaming_example_gives_the_jax_facades_fens(jax_facade, capsys) -> None:
    st = _example("torch_streaming_throughput")
    frames, _ = st.input_frames(1)
    res = st.main(2, 2, device="cpu", dtype=torch.float32, seed=1)
    lines = capsys.readouterr().out.splitlines()
    assert res["batch"].shape == (2, 512, 512, 3)
    found, fen = jax_facade(frames[0])
    assert found and len(res["fens"]) == 2
    for fens, ok in zip(res["fens"], res["found"]):
        assert fens == [fen, fen] and ok.tolist() == [True, True]
    assert lines[-1] == f"sample FEN: {fen}"
    assert "4 boards in" in lines[-2] and "boards/s (streamed, yuv444, batch 2)" in lines[-2]


def test_streaming_example_from_its_command_line(jax_facade) -> None:
    """The positional batch count and size and ``--device`` reach ``main``."""
    st = _example("torch_streaming_throughput")
    frames, _ = st.input_frames(1)
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_streaming_throughput.py"), "1", "1",
         "--device", "cpu", "--dtype", "float32", "--seed", "1"],
        cwd=REPO / "examples", capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == f"sample FEN: {jax_facade(frames[0])[1]}"
    assert "1 boards in" in lines[-2] and "batch 1)" in lines[-2]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_detailed_example", "torch_streaming_throughput"])
def test_examples_raise_without_a_gpu(name) -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main()


# -- the wrappers ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_parses(name) -> None:
    out = subprocess.run(["bash", "-n", str(BIN / f"torch_{name}.sh")], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def _recorded_argv(script: Path, tmp_path: Path) -> list[str]:
    """The command line that ``script`` runs, read from stand-ins for
    ``python`` and ``torchrun`` first on the ``PATH``."""
    record = tmp_path / f"{script.stem}.argv"
    fakes = tmp_path / "bin"
    fakes.mkdir(exist_ok=True)
    for tool in ("python", "torchrun"):
        (fakes / tool).write_text('#!/bin/sh\nprintf "%s\\n" "$@" > "$RECORD"\n')
        (fakes / tool).chmod(0o755)
    unset = ("PYTHON", "TORCHRUN", "PORT", "NPROC", "TORCHRUN_ARGS")
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update(PATH=f"{fakes}{os.pathsep}{env.get('PATH', '')}", RECORD=str(record))
    subprocess.run(["bash", str(script)], env=env, check=True, timeout=60)
    return record.read_text().splitlines()


class _Reached(Exception):
    pass


# the module's function behind main(), stood in for so that nothing runs
_DRIVEN = {
    "chessvision_tpu_torch.eval.evaluate": ["evaluate_model"],
    "chessvision_tpu_torch.serve.server": ["serve"],
    "chessvision_tpu_torch.train.train_unet": ["train_model"],
    "chessvision_tpu_torch.train.train_classifier": ["train_model"],
    "chessvision_tpu_torch.train.sweep": ["run_sweep"],
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_calls_a_port_module_with_the_jax_wrappers_defaults(name, tmp_path, monkeypatch) -> None:
    argv = _recorded_argv(BIN / f"torch_{name}.sh", tmp_path)
    jax_argv = _recorded_argv(BIN / f"{name}.sh", tmp_path)
    assert jax_argv[0] == "-m" and jax_argv[1].startswith("chessvision_tpu.")
    if name == "train_distributed":
        from torch.distributed.run import get_args_parser

        run = get_args_parser().parse_args(argv)
        assert run.nproc_per_node == "1" and run.module
        argv = ["-m", run.training_script, *run.training_script_args]
    assert argv[0] == "-m" and argv[1] == jax_argv[1].replace("chessvision_tpu.", "chessvision_tpu_torch.", 1)
    assert argv[2:] == jax_argv[2:]

    module = importlib.import_module(argv[1])
    seen: dict = {}

    def reached(*args, **kwargs):
        seen.update(kwargs)
        raise _Reached

    for fn in _DRIVEN[argv[1]]:
        monkeypatch.setattr(module, fn, reached)
    with pytest.raises(_Reached):
        module.main(argv[2:])
    assert seen
    if name.startswith("train_") and name != "train_board_extractor_sweep":
        want_epochs = int(argv[argv.index("--epochs") + 1])
        assert seen["epochs"] == want_epochs and seen["batch_size"] == int(argv[argv.index("--batch-size") + 1])
    if name == "serve":
        assert seen["port"] == 7777
    if name == "evaluate":
        assert seen["include_metrics_table"] is True
