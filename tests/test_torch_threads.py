"""The port under several threads of one process, on the CPU.

- ``utils.full_f32``: torch keeps the TF32 flags for the whole process.
  Two threads' blocks replayed in a fixed order (A enters, B enters, A
  leaves, B reads, B leaves) must leave both flags False inside B's block
  and give the caller's settings back after both; nested blocks in one
  thread likewise.
- ``cuda_build.load``: four threads that ask at once for a kernel not yet
  built must all get it, from one build.  A stand-in compiler (a Python
  script that sleeps, then writes its ``-o`` file) and a stand-in loader
  take the places of ``nvcc`` and ``ctypes``, so no compiler and no GPU
  are needed; a compiler that fails raises in every thread.

The card's own case (two threads calling ``process_batch`` on 12 MP
frames) is in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import os
import stat
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from chessvision_tpu_torch import cuda_build, utils


def _flags() -> tuple[bool, bool]:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_flags():
    """The process's flags around a test, restored after it."""
    saved = _flags()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _run(*targets) -> None:
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


@pytest.mark.parametrize("start", [(True, True), (True, False), (False, True)], ids=str)
def test_full_f32_holds_the_flags_off_across_interleaved_threads(tf32_flags, start) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = start
    a_in, b_in, a_out, b_read = (threading.Event() for _ in range(4))
    seen: dict[str, tuple[bool, bool]] = {}
    errors: list[Exception] = []

    def a() -> None:
        try:
            with utils.full_f32():
                seen["a"] = _flags()
                a_in.set()
                assert b_in.wait(10)
            a_out.set()
        except Exception as e:  # reported by the main thread
            errors.append(e)
            a_out.set()

    def b() -> None:
        try:
            assert a_in.wait(10)
            with utils.full_f32():
                b_in.set()
                assert a_out.wait(10)
                seen["b after a left"] = _flags()
            b_read.set()
        except Exception as e:  # reported by the main thread
            errors.append(e)
            b_in.set()

    _run(a, b)
    assert not errors, errors
    assert b_read.is_set()
    assert seen == {"a": (False, False), "b after a left": (False, False)}
    assert _flags() == start


def test_full_f32_nested_in_one_thread_restores_the_callers_flags(tf32_flags) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, False
    with utils.full_f32():
        assert _flags() == (False, False)
        with utils.full_f32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, False)
    # a block after the caller changed its settings restores the new ones
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    with pytest.raises(KeyError):
        with utils.full_f32():
            raise KeyError("leaves the block by an exception")
    assert _flags() == (False, True)


def test_full_f32_many_threads_leave_the_callers_flags(tf32_flags) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    inside: list[tuple[bool, bool]] = []
    go = threading.Barrier(8)

    def work() -> None:
        go.wait(10)
        for _ in range(200):
            with utils.full_f32():
                inside.append(_flags())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        _run(*[work] * 8)
    finally:
        sys.setswitchinterval(interval)
    assert len(inside) == 1600 and set(inside) == {(False, False)}
    assert _flags() == (True, True)


# -- the first build of a kernel from several threads ------------------------------------------

STAND_IN = """\
import sys, time
from pathlib import Path
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
time.sleep(0.5)
if {fail!r}:
    print("error: stand-in compiler refused the source")
    sys.exit(1)
Path(args[args.index("-o") + 1]).write_bytes(b"a stand-in library")
"""


@pytest.fixture
def stand_in_build(tmp_path, monkeypatch):
    """``cuda_build`` pointed at an empty build directory, a source
    ``k.cu``, a stand-in compiler and a loader that records what it
    opens.  Returns a function that sets whether the compiler fails, and
    the compiler's log and the loader's list."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    log, opened = tmp_path / "compiles.log", []

    def make(fail: bool) -> tuple[Path, list[str]]:
        script = tmp_path / "nvcc"
        script.write_text(f"#!{sys.executable}\n" + STAND_IN.format(log=str(log), fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IXUSR)
        monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(script))
        return log, opened

    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "ctypes", types.SimpleNamespace(CDLL=lambda p: opened.append(p) or ("lib", p)))
    return make


def _load_in_threads(n: int) -> tuple[list, list[Exception]]:
    go = threading.Barrier(n)
    libs, errors = [], []

    def work() -> None:
        go.wait(10)
        try:
            libs.append(cuda_build.load("k"))
        except Exception as e:  # reported by the main thread
            errors.append(e)

    _run(*[work] * n)
    return libs, errors


def test_four_threads_first_load_builds_once(stand_in_build) -> None:
    log, opened = stand_in_build(fail=False)
    libs, errors = _load_in_threads(4)
    assert not errors, errors
    out = cuda_build.library_path("k")
    assert len(libs) == 4 and all(lib == ("lib", str(out)) for lib in libs)
    assert len(log.read_text().splitlines()) == 1  # one compile
    assert opened == [str(out)]  # one load
    assert out.read_bytes() == b"a stand-in library"
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]  # no temporary file left
    assert cuda_build.load("k") is libs[0]


def test_a_failed_build_raises_in_every_thread(stand_in_build) -> None:
    log, opened = stand_in_build(fail=True)
    libs, errors = _load_in_threads(4)
    assert not libs and len(errors) == 4
    assert all(isinstance(e, RuntimeError) and "stand-in compiler refused" in str(e) for e in errors)
    assert not opened and not cuda_build.library_path("k").exists()
    assert not list(cuda_build.library_path("k").parent.iterdir())  # the temporary files removed


def test_builds_started_at_once_write_files_of_their_own(stand_in_build) -> None:
    """Two builds of one kernel that overlap (two threads past the lock,
    as two processes would be) each write their own temporary file, and
    both land."""
    log, _ = stand_in_build(fail=False)
    started: list = []
    both = threading.Barrier(2)

    def build() -> None:
        started.append(cuda_build._start_build("k", verbose=False))
        both.wait(timeout=30)  # alive until the other has started: a finished thread's ident is reused

    _run(build, build)
    assert len({s[1] for s in started}) == 2
    assert all(str(os.getpid()) in s[1].name for s in started)
    errors = []
    for out, tmp, proc in started:
        try:
            cuda_build._finish_build("k", out, tmp, proc, verbose=False)
        except Exception as e:  # reported by the main thread
            errors.append(e)
    assert not errors, errors
    assert cuda_build.library_path("k").read_bytes() == b"a stand-in library"
    assert len(log.read_text().splitlines()) == 2
