"""Three places where the port behaved otherwise than the JAX package, on
the CPU.

- ``Engine(mesh=…)``: the raw ``run_stream`` on a mesh of one process
  yields the tensors of the same engine without a mesh (the JAX stream
  runs its unsharded program); ``run_device`` on a one-process mesh
  returns tensors on the device, takes a tensor as well as numpy, and
  ``pad_to_multiple`` pads a tensor in torch as it pads an array;
- ``ChessVision.process_image`` refuses bad input with the JAX facade's
  exception type and messages, in its order, also under ``python -O``;
- ``eval.render.display_comparison`` composes its panels with numpy and
  cv2 and never imports matplotlib unless asked to show them.

The mesh cases run the stub extractor of tests/_torch_mesh_worker.py and
a seeded YoloCls (width 8); one or two 256² frames a call, which keeps
each rank's CPU pipeline well under a second.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chessvision_tpu.core import ChessVision as JaxChessVision
from chessvision_tpu.parallel import mesh as jmesh
from chessvision_tpu_torch import models
from chessvision_tpu_torch.core import ChessVision
from chessvision_tpu_torch.cv_types import ChessVisionResult
from chessvision_tpu_torch.eval import render
from chessvision_tpu_torch.parallel import mesh as tmesh
from tests import _torch_mesh_worker as worker

REPO = Path(__file__).resolve().parent.parent
KEYS = ("logits", "quadrangle", "found", "board_image", "probabilities")


# -- Engine(mesh=…) and device tensors ---------------------------------------------------


@pytest.fixture(scope="module")
def yolo_state() -> dict:
    torch.manual_seed(0)
    return models.create_classifier("yolo", width=8)[0].state_dict()


def test_raw_stream_on_a_one_process_mesh_yields_the_mesh_free_tensors(yolo_state) -> None:
    frames = worker.engine_batch()
    batches = [frames[:1], frames[1:2]]
    meshed = worker.build_engine(tmesh.create_mesh(device="cpu"), yolo_state)
    plain = worker.build_engine(None, yolo_state)
    got = list(meshed.run_stream(batches, kind="raw"))
    want = list(plain.run_stream(batches, kind="raw"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(KEYS)
        for k in KEYS:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu", k
            assert torch.equal(g[k], w[k]), k
    assert bool(got[0]["found"][0])


def test_run_device_on_a_one_process_mesh_returns_tensors_given_a_tensor(yolo_state) -> None:
    frames = worker.engine_batch()[2:3]
    meshed = worker.build_engine(tmesh.create_mesh(device="cpu"), yolo_state)
    got = meshed.run_device(torch.from_numpy(frames))
    want = worker.build_engine(None, yolo_state).run_device(frames)
    for k in KEYS:
        assert isinstance(got[k], torch.Tensor), k
        assert torch.equal(got[k], want[k]), k
    res = meshed.process_batch(frames, lite=True)  # on a mesh lite takes the full path, as in JAX
    assert res.logits.shape == (1, 256, 256) and res.board_image.shape == (1, 512, 512)
    assert res.binary_mask.dtype == np.uint8 and res.fens[0]


@pytest.mark.parametrize("b,multiple", [(3, 2), (4, 2), (5, 4), (1, 3)])
def test_pad_to_multiple_pads_a_tensor_as_jax_pads_an_array(b, multiple) -> None:
    batch = np.arange(b * 6, dtype=np.uint8).reshape(b, 2, 3)
    got, n = tmesh.pad_to_multiple(torch.from_numpy(batch), multiple)
    want, wn = jmesh.pad_to_multiple(batch, multiple)
    assert isinstance(got, torch.Tensor) and n == wn
    assert np.array_equal(got.numpy(), want)


# -- facade input checks -----------------------------------------------------------------


BAD_INPUTS = {
    "gray": np.zeros((512, 512), np.uint8),
    "float32": np.zeros((512, 512, 3), np.float32),
    "list": [[0, 0, 0]],
    "float32 gray": np.zeros((512, 512), np.float32),  # two checks fail: the first one speaks
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_process_image_refuses_bad_input_as_jax_does(name) -> None:
    image = BAD_INPUTS[name]
    # both facades lazy: the checks run before any model is built
    with pytest.raises(Exception) as want:
        JaxChessVision().process_image(image)
    with pytest.raises(Exception) as got:
        ChessVision(device="cpu").process_image(image)
    assert want.type is AssertionError
    assert got.type is want.type
    assert str(got.value) == str(want.value)


def test_process_image_checks_survive_python_O() -> None:
    code = (
        "import numpy as np\n"
        "from chessvision_tpu_torch.core import ChessVision\n"
        "try:\n"
        "    ChessVision(device='cpu').process_image(np.zeros((8, 8), np.uint8))\n"
        "except AssertionError as e:\n"
        "    print('refused:', e)\n"
    )
    out = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused: Image must be 3-dimensional (H,W,C)"


# -- display_comparison without matplotlib ---------------------------------------------------


@pytest.fixture(scope="module")
def results(yolo_state) -> dict[bool, ChessVisionResult]:
    """``process_image`` of the facade on the stub engine: the fixed
    quadrangle (a board found) and logits of −8 everywhere (none)."""
    blank = worker.FixedQuadExtractor()
    blank.logits.fill_(-8.0)
    out = {}
    for found, extractor in ((True, worker.FixedQuadExtractor()), (False, blank)):
        cv = ChessVision(device="cpu")
        cv._engine = worker.build_engine(None, yolo_state)
        cv._engine._extractor = extractor
        out[found] = cv.process_image(worker.engine_batch()[0])
        assert (out[found].position is not None) == found
    return out


def _width(n: int) -> int:
    return n * render.PANEL + (n - 1) * render.GAP


@pytest.mark.parametrize("found", [True, False], ids=["board", "no board"])
@pytest.mark.parametrize("with_input", [True, False], ids=["input", "no input"])
def test_display_comparison_composes_the_panels(tmp_path, results, found, with_input) -> None:
    image = np.random.default_rng(0).integers(0, 256, (480, 640, 3), np.uint8) if with_input else None
    path = tmp_path / "sub" / "comparison.png"
    composed = render.display_comparison(results[found], path, image=image)
    n = 2 + int(with_input) + 2 * int(found)
    assert composed.dtype == np.uint8 and composed.shape == (render.TITLE + render.PANEL, _width(n), 3)
    assert np.array_equal(cv2.imread(str(path)), composed)
    # the binary-mask panel shows the mask, resized to the panel
    col = (int(with_input) + 1) * (render.PANEL + render.GAP)
    mask_panel = composed[render.TITLE :, col : col + render.PANEL, 0]
    want = cv2.resize(results[found].board_extraction.binary_mask, (render.PANEL, render.PANEL),
                      interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(mask_panel, want)
    if found:  # the last panel is the rendered position
        last = composed[render.TITLE :, -render.PANEL :]
        board = cv2.resize(render.render_board(results[True].position.fen), (render.PANEL, render.PANEL),
                           interpolation=cv2.INTER_AREA)
        assert np.array_equal(last, board)


def test_display_comparison_never_imports_matplotlib(tmp_path, results) -> None:
    import pickle

    (tmp_path / "results.pkl").write_bytes(pickle.dumps([results[True], results[False]]))
    code = (
        "import pickle, sys\n"
        "from chessvision_tpu_torch.eval.render import display_comparison\n"
        f"found, missing = pickle.loads(open({str(tmp_path / 'results.pkl')!r}, 'rb').read())\n"
        f"img = display_comparison(found, {str(tmp_path / 'c.png')!r})\n"
        "img = display_comparison(missing, None)\n"
        "print(img.shape, sorted(m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'jax')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"(280, {_width(2)}, 3) []", out.stdout
    assert (tmp_path / "c.png").is_file()
