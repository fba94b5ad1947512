"""The port's native loader binding (``chessvision_tpu_torch/native_loader``)
against the JAX package's binding and against numpy/cv2, on the CPU.

The port builds ``native/cvloader/cvloader.cpp`` into
``build/cvloader_torch/``; these tests skip only where that build cannot
run (no compiler or no libjpeg/libpng headers), with the reason in the
skip.  Bounds: the packers bit-identical to the numpy packers and to the
JAX package's native packers; decodes bit-identical to the JAX package's
native decode of the same file (the same source and libjpeg), and to
cv2's decode + INTER_AREA within the JAX test's bound for JPEG (mean
|Δ| < 2, fewer than 1% of values off by more than 8) and exactly for PNG.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from chessvision_tpu import native_loader as jnl
from chessvision_tpu_torch import engine as tengine
from chessvision_tpu_torch import native_loader as tnl
from chessvision_tpu_torch.synthetic import board_frames

_BUILT, _WHY = tnl.build_status()
pytestmark = pytest.mark.skipif(not _BUILT, reason=f"the port's cvloader did not build: {_WHY}")


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    return board_frames(3, 4)[0]


@pytest.fixture(scope="module")
def files(tmp_path_factory, frames) -> list[str]:
    import cv2

    root = tmp_path_factory.mktemp("frames")
    paths = []
    for i, f in enumerate(frames):
        p = root / (f"f{i}.jpg" if i % 2 == 0 else f"f{i}.png")
        cv2.imwrite(str(p), f)
        paths.append(str(p))
    return paths


def test_library_lives_in_the_ports_build_dir() -> None:
    lib = Path(tnl._LIB_PATH).resolve()
    assert lib.exists() and lib.parent.name == "cvloader_torch" and lib.parent.parent.name == "build"
    assert "chessvision_tpu/lib" not in lib.as_posix()


def test_packers_native_equal_numpy_and_jax(frames) -> None:
    comp, gray = tengine.pack_inputs(frames)
    cb, cr, gres = tnl.pack_yuv444(comp, gray)
    for got, want in zip((cb, cr, gres), tengine._pack_yuv444_numpy(comp, gray)):
        assert np.array_equal(got, want)
    cb2, cr2 = tnl.pack_yuv420(comp, gray)
    for got, want in zip((cb2, cr2), tengine._pack_yuv420_numpy(comp, gray)):
        assert np.array_equal(got, want)
    if jnl.available():
        for got, want in zip((cb, cr, gres), jnl.pack_yuv444(comp, gray)):
            assert np.array_equal(got, want)
        for got, want in zip((cb2, cr2), jnl.pack_yuv420(comp, gray)):
            assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tnl.pack_yuv444(comp.astype(np.int16), gray)
    with pytest.raises(ValueError):
        tnl.pack_yuv420(comp, gray[:, :-1])
    # the engine's packers take the native branch and give the same bytes
    y, *rest = tengine.pack_inputs_yuv444(frames)
    assert np.array_equal(y, gray) and all(np.array_equal(a, b) for a, b in zip(rest, (cb, cr, gres)))
    y, *rest = tengine.pack_inputs_yuv(frames)
    assert np.array_equal(y, gray) and all(np.array_equal(a, b) for a, b in zip(rest, (cb2, cr2)))


def test_load_image_and_batch_match_cv2_and_jax(files) -> None:
    import cv2

    batch, failures = tnl.load_batch(files, 256, 256, 3, n_threads=4)
    assert failures == 0 and batch.shape == (4, 256, 256, 3)
    for i, path in enumerate(files):
        single = tnl.load_image(path, 256, 256, 3)
        assert np.array_equal(batch[i], single)
        if jnl.available():
            assert np.array_equal(single, jnl.load_image(path, 256, 256, 3))
        want = cv2.resize(cv2.imread(path), (256, 256), interpolation=cv2.INTER_AREA)
        diff = np.abs(single.astype(int) - want.astype(int))
        if path.endswith(".png"):
            assert diff.max() <= 1, diff.max()
        else:
            assert diff.mean() < 2.0 and (diff > 8).mean() < 0.01
    gray = tnl.load_image(files[1], 128, 128, 1)
    assert gray.shape == (128, 128)


def test_load_batch_missing_file_zeroed(files) -> None:
    batch, failures = tnl.load_batch(files[:2] + ["/nonexistent/nope.jpg"], 64, 64, 3)
    assert failures == 1 and batch[2].sum() == 0 and batch[0].sum() > 0


def test_prefetcher_cycles_and_shuffles(files) -> None:
    pf = tnl.Prefetcher(files, batch=3, h=64, w=64, n_threads=2, shuffle=True, seed=7)
    seen = []
    for _ in range(4):
        batch, idx = pf.next()
        assert batch.shape == (3, 64, 64, 3) and ((idx >= 0) & (idx < 4)).all()
        seen.extend(idx.tolist())
    pf.close()
    assert set(seen) == {0, 1, 2, 3}


def test_cv2_fallback_where_the_library_is_missing(monkeypatch, files) -> None:
    import cv2

    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_status", (False, "build failed: test"))
    assert not tnl.available() and not tnl.has_pack_yuv444()
    batch, failures = tnl.load_batch(files, 96, 96, 3)
    want = np.stack([cv2.resize(cv2.imread(p), (96, 96), interpolation=cv2.INTER_AREA) for p in files])
    assert failures == 0 and np.array_equal(batch, want)
    with pytest.raises(RuntimeError):
        tnl.Prefetcher(files, 2, 64, 64)
