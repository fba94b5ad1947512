"""``graft_entry_torch.py`` against ``__graft_entry__.py``, on the CPU.

- ``entry()``: the example arguments and the forward's outputs have the
  keys, shapes and dtypes (numpy names) of the JAX ``entry()``'s.  The two
  random inits differ, so values are not compared.  The JAX side is
  traced with ``jax.eval_shape`` (its init and its forward, on the first
  two frames), which compiles nothing.
- ``dryrun_multichip``: two gloo ranks print the JAX line's format, with
  finite losses equal on both ranks; one rank runs in this process; on the
  card it needs a card a rank.

B=8 and eight ranks are marked ``slow``.
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import graft_entry_torch as graft
from chessvision_tpu_torch import models

LINE = re.compile(
    r"^dryrun_multichip ok on (\d+) devices: seg loss (\S+), cls loss (\S+), engine batch \((\d+), 64, 13\)$"
)


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.") if isinstance(t, torch.Tensor) else np.dtype(t.dtype).name


def _layout(tree) -> dict:
    return {k: (tuple(v.shape), _dtype_name(v)) for k, v in tree.items()}


def _jax_layouts(batch: int) -> tuple[list, dict]:
    """The JAX ``entry()``'s example arguments and its forward's outputs on
    ``batch`` frames, as shapes and dtype names, traced without compiling."""
    args = jax.eval_shape(lambda: jax_graft.entry()[1])
    frames = jax.ShapeDtypeStruct((batch,) + args[0].shape[1:], args[0].dtype)
    out = jax.eval_shape(lambda images, threshold: jax_graft.entry()[0](images, threshold), frames, args[1])
    return [(tuple(a.shape), _dtype_name(a)) for a in args], _layout(out)


@pytest.mark.parametrize("batch", [2, pytest.param(8, marks=pytest.mark.slow)])
def test_entry_matches_the_jax_entrys_layout(batch) -> None:
    before = torch.random.get_rng_state()
    fn, (images, threshold) = graft.entry(device="cpu", batch=batch)
    assert torch.equal(torch.random.get_rng_state(), before)  # the caller's generator is untouched
    want_args, want_out = _jax_layouts(batch)
    (want_images, want_threshold) = want_args
    assert (tuple(images.shape), _dtype_name(images)) == ((batch,) + want_images[0][1:], want_images[1])
    assert (tuple(threshold.shape), _dtype_name(threshold)) == want_threshold
    if batch == 8:
        assert tuple(images.shape) == want_images[0]
    assert images.device.type == "cpu" and not images.any() and float(threshold) == 0.5
    out = fn(images, threshold)
    assert _layout(out) == want_out
    assert all(v.device.type == "cpu" for v in out.values())
    assert torch.isfinite(out["probabilities"]).all()



def _check_dryrun(recs: list[dict], n: int, printed: str) -> None:
    assert [r["rank"] for r in recs] == list(range(n))
    assert all(r["world"] == n and r["engine_batch"] == [n, 64, 13] for r in recs)
    seg, cls = recs[0]["seg_loss"], recs[0]["cls_loss"]
    assert np.isfinite(seg) and np.isfinite(cls)
    assert all((r["seg_loss"], r["cls_loss"]) == (seg, cls) for r in recs)
    lines = [ln for ln in printed.splitlines() if ln.startswith("dryrun_multichip")]
    assert lines == [recs[0]["line"]]  # rank 0 prints, once
    m = LINE.match(lines[0])
    assert m and int(m.group(1)) == n and int(m.group(4)) == n
    assert (float(m.group(2)), float(m.group(3))) == (round(seg, 4), round(cls, 4))


@pytest.mark.parametrize("n", [2, pytest.param(8, marks=pytest.mark.slow)])
def test_dryrun_over_gloo_ranks(n, capfd) -> None:
    recs = graft.dryrun_multichip(n, device="cpu")
    assert {r["backend"] for r in recs} == {"gloo"} and len({r["pid"] for r in recs}) == n
    assert os.getpid() not in {r["pid"] for r in recs}
    _check_dryrun(recs, n, capfd.readouterr().out)


def test_dryrun_of_one_rank_runs_in_this_process(capfd) -> None:
    recs = graft.dryrun_multichip(1, device="cpu", probe=os.getpid)
    assert recs[0]["pid"] == os.getpid() and recs[0]["probe"] == os.getpid()
    assert recs[0]["backend"] is None and not torch.distributed.is_initialized()
    _check_dryrun(recs, 1, capfd.readouterr().out)


def test_dryrun_on_the_card_needs_a_card_a_rank(monkeypatch) -> None:
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft.entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\) runs one rank a card and this machine shows 1"):
        graft.dryrun_multichip(2)
    with pytest.raises(ValueError):
        graft.dryrun_multichip(0, device="cpu")


def test_models_are_seeded_without_touching_the_callers_generator() -> None:
    before = torch.random.get_rng_state()
    a, b = (graft._seeded(lambda: models.create_extractor("unet", base=8)[0].state_dict()) for _ in range(2))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_a_failing_rank_makes_the_call_raise() -> None:
    """A rank that raises fails the whole call (here rank 1 of two, through
    a probe that raises only there)."""
    with pytest.raises(Exception, match="rank 1 refuses"):
        graft.dryrun_multichip(2, device="cpu", probe=_refuse_on_rank_one)


def _refuse_on_rank_one() -> int:
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 refuses")
    return 0

