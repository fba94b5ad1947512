"""The metric arithmetic: rates and tails over every request of the
window, the device's idle share from the union of intervals, the
roofline shares."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import loop, spec, trace


class _Sleeper(loop.Entry):
    """A entry whose requests sleep; request ``stall`` sleeps longer."""

    boards_per_request = 8

    def __init__(self, each: float, stall: int | None, stall_s: float) -> None:
        super().__init__(None, [np.zeros(1)], 0.5, {})
        self.each, self.stall, self.stall_s = each, stall, stall_s

    def requests(self, start):
        i = start
        while True:
            t = self.stall_s if i == self.stall else self.each
            yield 0, (lambda t=t: time.sleep(t) or {})
            i += 1


def _window(stall):
    w = loop.closed_loop(_Sleeper(0.01, stall, 0.25), 0.6, None, loop.Reservoir(0, np.random.default_rng(0)))
    return SimpleNamespace(**w, seconds=w["end"] - w["begin"], setup_s=1.0)


def test_a_stall_moves_the_rate_and_the_tail():
    calm, stalled = _window(None), _window(5)
    rate = spec.end_to_end("boards_per_s").read
    p95 = spec.end_to_end("latency_p95_ms").read
    p50 = spec.end_to_end("latency_p50_ms").read
    assert rate(stalled) < 0.8 * rate(calm)
    assert calm.attempted > 30 and stalled.attempted < calm.attempted
    # one stalled request among ~40 moves the 95th percentile only if it is
    # taken over every request; twenty of them must
    many = loop.closed_loop(_ManyStalls(), 1.0, None, loop.Reservoir(0, np.random.default_rng(0)))
    many = SimpleNamespace(**many, seconds=many["end"] - many["begin"], setup_s=1.0)
    assert p95(many) > 100.0 > p50(many)
    assert p50(stalled) < 20.0


class _ManyStalls(_Sleeper):
    def __init__(self):
        super().__init__(0.005, None, 0.0)

    def requests(self, start):
        i = start
        while True:
            yield 0, (lambda i=i: time.sleep(0.12 if i % 10 == 9 else 0.005) or {})
            i += 1


def test_the_window_counts_requests_that_failed():
    class Failing(_Sleeper):
        def requests(self, start):
            i = start
            while True:
                def call(i=i):
                    if i % 3 == 0:
                        raise RuntimeError("no answer")
                    return {}
                yield 0, call
                i += 1

    w = loop.closed_loop(Failing(0, None, 0), None, 9, loop.Reservoir(0, np.random.default_rng(0)))
    assert (w["attempted"], w["failed"], len(w["latency_s"])) == (9, 3, 6)


def test_idle_share_counts_overlapping_streams_once():
    t = trace.TraceData(
        kernels=[(0.0, 400.0, "a"), (100.0, 300.0, "b"), (600.0, 700.0, "c")],
        copies=[(350.0, 500.0, "Memcpy HtoD (Pinned -> Device)")],
        window=(0.0, 1000.0), requests=2, boards=4,
    )
    assert t.busy_s == pytest.approx(600e-6)
    summed = sum(b - a for a, b, _ in t.kernels + t.copies) / 1e6  # as profiling.device_busy sums
    assert summed == pytest.approx(850e-6) and summed > t.busy_s
    idle = spec.reader("device_idle_pct.batch").read(SimpleNamespace(trace=t))
    assert idle == pytest.approx(40.0)
    assert t.h2d_under_kernels_pct() == pytest.approx(100.0 * 50 / 150)
    b = t.breakdown()
    assert b["idle_gaps"][0][1] == pytest.approx(300e-6) and len(b["idle_gaps"]) == 2
    assert b["device_ops"][0] == ["a", pytest.approx(400e-6)]


def test_rooflines_and_mfu():
    t = trace.TraceData(kernels=[(0.0, 100.0, "void warp_fused_kernel(float const*)"),
                                 (100.0, 300.0, "bn_act_dense_kernel<__nv_bfloat16>"),
                                 (300.0, 1000.0, "other")],
                        window=(0.0, 2000.0), requests=4, boards=8)
    ctx = SimpleNamespace(trace=t, peaks={"bf16_flop_per_s": 1e12, "bytes_per_s": 1e9},
                          k1_floor_bytes=lambda: 5e4, bn_act_bytes=lambda: 1e5, flops_per_board=lambda: 1e6)
    assert spec.reader("k1_roofline.batch").read(ctx) == pytest.approx(50.0)  # 50 µs floor over 100 µs
    assert spec.reader("bn_act_roofline.batch").read(ctx) == pytest.approx(50.0)
    assert spec.reader("mfu.batch").read(ctx) == pytest.approx(100.0 * 8e6 / 2e-3 / 1e12)
    assert spec.reader("launches_per_request.photo").read(ctx) is None
    ctx.peaks = None
    assert spec.reader("k1_roofline.photo").read(ctx) is None


def test_readers_return_nothing_on_an_empty_trace():
    ctx = SimpleNamespace(trace=trace.TraceData(), peaks=None, synced_ms={}, synced_requests=0)
    bench = spec.ROOT / "BENCHMARK.json"
    import json

    for m in json.loads(bench.read_text())["per_layer"]:
        assert spec.reader(m["name"]).read(ctx) is None, m["name"]


def test_one_reader_serves_the_metrics_of_one_name():
    """``mfu.batch`` and ``mfu.photo`` move different end-to-end metrics
    and are read by the one file ``layer_metrics/mfu.py``."""
    assert spec.reader("mfu.batch") is spec.reader("mfu.photo") is spec.reader("mfu")
    names = {p.stem for p in (spec.HERE / "layer_metrics").glob("*.py")}
    import json

    for m in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        assert m["name"] in names or m["name"].rsplit(".", 1)[0] in names, m["name"]


def _event(name, a, b, device_type, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), device_type=device_type,
                           is_user_annotation=annotation)


def test_annotation_mirrors_are_not_device_work():
    """A ``record_function`` span in the program is a user annotation, and
    the profiler mirrors it onto the device's timeline; the mirror holds no
    device work, whatever its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as real:
        with record_function("model:block"):
            torch.ones(4).sum()
    assert any(e.name == "model:block" and e.is_user_annotation for e in real.events())

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _event(trace.REQUEST_SPAN, 0.0, 1000.0, cpu, True),
        _event("model:block", 100.0, 900.0, cpu, True),
        _event("cudaLaunchKernel", 150.0, 160.0, cpu),
        _event("gemm_kernel", 200.0, 300.0, cuda),
        _event("model:block", 200.0, 800.0, cuda, True),
        _event(trace.REQUEST_SPAN, 0.0, 1000.0, cuda, True),
    ]
    t = trace.from_profiler(SimpleNamespace(events=lambda: events), requests=1, boards=1)
    assert t.kernels == [(200.0, 300.0, "gemm_kernel")] and t.copies == []
    assert t.busy_s == pytest.approx(100e-6) and t.launches == 1
    assert spec.reader("device_idle_pct.batch").read(SimpleNamespace(trace=t)) == pytest.approx(90.0)


@pytest.mark.cuda
def test_annotation_mirrors_are_not_device_work_on_the_card(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn((1024, 1024), device=card)
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.REQUEST_SPAN):
            with record_function("model:block"):
                y = x @ x
            torch.cuda.synchronize(card)
    del y
    cuda = torch.autograd.DeviceType.CUDA
    mirrors = [e.name for e in prof.events() if e.device_type == cuda and e.is_user_annotation]
    assert "model:block" in mirrors, sorted({e.name for e in prof.events() if e.device_type == cuda})
    t = trace.from_profiler(prof, requests=1, boards=1)
    names = [n for _, _, n in t.kernels + t.copies]
    assert names and not any(n.startswith(("model:", trace.SPAN_PREFIX)) for n in names), names
