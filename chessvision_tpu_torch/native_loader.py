"""The port's ctypes binding of the native C++ data loader
(``native/cvloader/cvloader.cpp``), the counterpart of
``chessvision_tpu/native_loader.py``.

Threaded JPEG/PNG decode + INTER_AREA resize, a background prefetch ring
of NHWC uint8 batches, and the fused host packers of the engine's yuv
input codecs.  The library is built from the checkout's source at first
use, into ``build/cvloader_torch/`` (g++ or c++ where present, else CMake
over a generated project), never into the JAX package's ``lib/``.  Where
it cannot be built (no compiler, no libjpeg/libpng headers) the loaders
decode with cv2, and the reason is logged once (``build_status``).

Build by hand: python -m chessvision_tpu_torch.native_loader --build
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "cvloader" / "cvloader.cpp"
_BUILD_DIR = _REPO / "build" / "cvloader_torch"
_LIB_PATH = _BUILD_DIR / "libcvloader.so"

_lib: ctypes.CDLL | None = None
_status: tuple[bool, str] | None = None

_CMAKE_PROJECT = """cmake_minimum_required(VERSION 3.16)
project(cvloader_torch CXX)
set(CMAKE_CXX_STANDARD 17)
set(CMAKE_BUILD_TYPE Release)
set(CMAKE_CXX_FLAGS_RELEASE "-O3 -march=native")
find_package(JPEG REQUIRED)
find_package(PNG REQUIRED)
find_package(Threads REQUIRED)
add_library(cvloader SHARED "{src}")
target_link_libraries(cvloader PRIVATE JPEG::JPEG PNG::PNG Threads::Threads)
set_target_properties(cvloader PROPERTIES LIBRARY_OUTPUT_DIRECTORY "{out}")
"""


def headers_present() -> bool:
    """Whether libjpeg's and libpng's headers are where a compiler looks."""
    inc = [Path("/usr/include"), Path("/usr/local/include")]
    return any((d / "jpeglib.h").exists() for d in inc) and any(
        (d / "png.h").exists() or (d / "libpng16" / "png.h").exists() for d in inc
    )


def _compile(out: Path) -> None:
    """Build the shared library at ``out``; raises on failure."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is not None:
        subprocess.run(
            [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(out),
             "-ljpeg", "-lpng", "-lpthread"],
            check=True, capture_output=True, text=True,
        )
        return
    if shutil.which("cmake") is None:
        raise FileNotFoundError("no C++ compiler (g++, c++) and no cmake")
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        src_dir, bin_dir, lib_dir = Path(tmp) / "src", Path(tmp) / "bin", Path(tmp) / "lib"
        src_dir.mkdir()
        (src_dir / "CMakeLists.txt").write_text(_CMAKE_PROJECT.format(src=_SRC.as_posix(), out=lib_dir.as_posix()))
        subprocess.run(["cmake", "-S", str(src_dir), "-B", str(bin_dir)], check=True, capture_output=True, text=True)
        subprocess.run(["cmake", "--build", str(bin_dir), "--parallel"], check=True, capture_output=True, text=True)
        shutil.move(str(lib_dir / "libcvloader.so"), out)


def build_library(force: bool = False) -> bool:
    """Build ``build/cvloader_torch/libcvloader.so`` from the checkout's
    source (again when the source is newer); True on success."""
    global _status
    if _LIB_PATH.exists() and not force and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        _status = (True, f"built: {_LIB_PATH}")
        return True
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: concurrent builders never load a
    # half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        _compile(Path(tmp))
        os.replace(tmp, _LIB_PATH)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or ""
        _status = (False, f"build failed: {e} {detail[-400:]}".strip())
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _status = (True, f"built: {_LIB_PATH}")
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _status
    if _lib is not None:
        return _lib
    if _status is not None and not _status[0]:
        return None
    lib = None
    # a library left by a build on another machine may not load here: one
    # rebuild, then cv2
    for force in (False, True):
        if not build_library(force=force):
            break
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            break
        except OSError as e:
            _status = (False, f"load failed: {e}")
    if lib is None:
        logger.warning("native cvloader unavailable (%s): decoding with cv2", _status[1] if _status else "")
        return None
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    paths_t = ctypes.POINTER(ctypes.c_char_p)
    lib.cvl_load_image.argtypes = [ctypes.c_char_p, c_int, c_int, c_int, c_void_p]
    lib.cvl_load_image.restype = c_int
    lib.cvl_load_batch.argtypes = [paths_t, c_int, c_int, c_int, c_int, c_void_p, c_int]
    lib.cvl_load_batch.restype = c_int
    lib.cvl_prefetcher_create.argtypes = [paths_t, c_int, c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_uint64, c_int]
    lib.cvl_prefetcher_create.restype = c_void_p
    lib.cvl_prefetcher_next.argtypes = [c_void_p, c_void_p, c_void_p]
    lib.cvl_prefetcher_next.restype = c_int
    lib.cvl_prefetcher_destroy.argtypes = [c_void_p]
    lib.cvl_pack_yuv444.argtypes = [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_void_p, c_void_p, c_void_p, c_int]
    lib.cvl_pack_yuv444.restype = None
    lib.cvl_pack_yuv420.argtypes = [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_void_p, c_void_p, c_int]
    lib.cvl_pack_yuv420.restype = None
    _lib = lib
    return lib


def build_status() -> tuple[bool, str]:
    """(built, why): builds on first call."""
    _load()
    assert _status is not None
    return _status


def available() -> bool:
    return _load() is not None


def has_pack_yuv444() -> bool:
    return available()


def has_pack_yuv420() -> bool:
    return available()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _pack_dims(comp: np.ndarray, gray: np.ndarray) -> tuple[int, int, int, int, int]:
    """(n, ih, iw, fh, fw) of ``pack_inputs``' outputs, checked before the
    library reads them through raw pointers."""
    if comp.dtype != np.uint8 or gray.dtype != np.uint8 or comp.ndim != 4 or comp.shape[3] != 3 or gray.ndim != 3:
        raise ValueError(f"need uint8 comp (n, ih, iw, 3) and gray (n, h, w), got {comp.shape} {comp.dtype}, "
                         f"{gray.shape} {gray.dtype}")
    n, ih, iw = comp.shape[:3]
    if gray.shape[0] != n or gray.shape[1] % ih or gray.shape[2] % iw or ih % 2 or iw % 2:
        raise ValueError(f"gray {gray.shape} is not an integer multiple of comp {comp.shape}")
    return n, ih, iw, gray.shape[1] // ih, gray.shape[2] // iw


def pack_yuv420(comp: np.ndarray, gray: np.ndarray, n_threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(cb, cr) 2×-subsampled chroma differences from ``pack_inputs``'s
    comp and gray: bit-identical to ``engine.pack_inputs_yuv``'s numpy."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native cvloader not available")
    n, ih, iw, fh, fw = _pack_dims(comp, gray)
    comp, gray = np.ascontiguousarray(comp), np.ascontiguousarray(gray)
    cb = np.empty((n, ih // 2, iw // 2), np.uint8)
    cr = np.empty_like(cb)
    lib.cvl_pack_yuv420(_ptr(comp), _ptr(gray), n, ih, iw, fh, fw, _ptr(cb), _ptr(cr), n_threads)
    return cb, cr


def pack_yuv444(comp: np.ndarray, gray: np.ndarray, n_threads: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cb, cr, gres) of the exact yuv444 codec in one pass: bit-identical
    to ``engine.pack_inputs_yuv444``'s numpy."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native cvloader not available")
    n, ih, iw, fh, fw = _pack_dims(comp, gray)
    comp, gray = np.ascontiguousarray(comp), np.ascontiguousarray(gray)
    cb = np.empty((n, ih, iw), np.uint8)
    cr = np.empty_like(cb)
    gres = np.empty((n, ih, iw // 2), np.uint8)
    lib.cvl_pack_yuv444(_ptr(comp), _ptr(gray), n, ih, iw, fh, fw, _ptr(cb), _ptr(cr), _ptr(gres), n_threads)
    return cb, cr, gres


def _paths_array(paths: list[str]) -> ctypes.Array:
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def load_image(path: str, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Decode and resize one image to (h, w, channels) uint8 (BGR)."""
    lib = _load()
    if lib is None:
        return _fallback_load(path, h, w, channels)
    out = np.empty((h, w, channels), np.uint8)
    if lib.cvl_load_image(str(path).encode(), h, w, channels, _ptr(out)) != 0:
        raise IOError(f"cvloader failed to decode {path}")
    return out if channels > 1 else out[..., 0]


def load_batch(paths: list[str], h: int, w: int, channels: int = 3, n_threads: int = 8) -> tuple[np.ndarray, int]:
    """Decode and resize a batch in parallel; returns (batch, failures).
    A file that fails to decode leaves zeros."""
    lib = _load()
    if lib is None:
        imgs = np.stack([_fallback_load(p, h, w, channels) for p in paths])
        return imgs.reshape(len(paths), h, w, channels), 0
    out = np.empty((len(paths), h, w, channels), np.uint8)
    failures = lib.cvl_load_batch(_paths_array(paths), len(paths), h, w, channels, _ptr(out), n_threads)
    return out, int(failures)


class Prefetcher:
    """Background batch producer over a file list (bounded ready ring)."""

    def __init__(
        self,
        paths: list[str],
        batch: int,
        h: int,
        w: int,
        channels: int = 3,
        n_threads: int = 8,
        shuffle: bool = True,
        seed: int = 0,
        max_ready: int = 4,
    ) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native cvloader not available")
        self._lib = lib
        self._paths_keepalive = _paths_array(paths)
        self._shape = (batch, h, w, channels)
        self._handle = lib.cvl_prefetcher_create(
            self._paths_keepalive, len(paths), batch, h, w, channels, n_threads, int(shuffle), seed, max_ready
        )

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """Blocking: (batch uint8 NHWC, source indices int64)."""
        out = np.empty(self._shape, np.uint8)
        idx = np.empty(self._shape[0], np.int64)
        if self._lib.cvl_prefetcher_next(self._handle, _ptr(out), _ptr(idx)) != 0:
            raise StopIteration
        return out, idx

    def close(self) -> None:
        if self._handle:
            self._lib.cvl_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def _fallback_load(path: str, h: int, w: int, channels: int) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE)
    if img is None:
        return np.zeros((h, w, channels) if channels > 1 else (h, w), np.uint8)
    if img.shape[:2] != (h, w):
        interp = cv2.INTER_AREA if img.shape[0] >= h else cv2.INTER_LINEAR
        img = cv2.resize(img, (w, h), interpolation=interp)
    return img


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--build", action="store_true")
    args = parser.parse_args()
    if args.build:
        ok = build_library(force=True)
        print(build_status()[1] if ok else f"FAILED: {_status[1] if _status else ''}")
