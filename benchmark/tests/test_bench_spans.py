"""The readers of the port's ``cv:`` spans on hand-made traces: the host's
wait on the device, the copy back, the upload and the stream's idle time
in its caller's hands.  Each reads nothing where the spans are absent (a
program without them)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec, trace


def _ctx(host, kernels=(), window=(0.0, 1000.0), requests=2):
    return SimpleNamespace(trace=trace.TraceData(kernels=list(kernels), host=list(host), window=window,
                                                 requests=requests, boards=2 * requests))


def _read(metric, ctx):
    return spec.reader(metric).read(ctx)


def test_host_wait_is_the_waits_share_of_the_window():
    host = [(0.0, 1000.0, "bench:request"), (100.0, 300.0, "cv:copy_back"), (100.0, 250.0, "cv:device_wait"),
            (600.0, 700.0, "cv:device_wait"), (950.0, 1100.0, "cv:device_wait")]  # the last half outside
    ctx = _ctx(host)
    assert _read("host_wait_pct.batch", ctx) == pytest.approx(100.0 * (150 + 100 + 50) / 1000)
    assert _read("host_wait_pct.photo", ctx) == _read("host_wait_pct.batch", ctx)
    assert _read("host_wait_pct.batch", _ctx(host[:2])) is None


def test_copy_back_leaves_out_the_wait_before_it():
    host = [(100.0, 300.0, "cv:copy_back"), (100.0, 250.0, "cv:device_wait"),
            (500.0, 900.0, "cv:copy_back"), (500.0, 520.0, "cv:device_wait"),
            (950.0, 990.0, "cv:device_wait"), (1200.0, 1300.0, "cv:copy_back")]  # a wait of no copy; one outside
    assert _read("copy_back_ms.batch", _ctx(host)) == pytest.approx((50 + 380) / 1e3 / 2)
    assert _read("copy_back_ms.batch", _ctx(host[1:2])) is None


def test_upload_is_the_upload_spans_a_request():
    host = [(0.0, 30.0, "cv:upload"), (40.0, 41.0, "cv:upload"), (500.0, 560.0, "cv:upload"),
            (600.0, 700.0, "bench:upload"), (2000.0, 2100.0, "cv:upload")]
    assert _read("upload_ms.batch", _ctx(host)) == pytest.approx(91 / 1e3 / 2)
    assert _read("upload_ms.photo", _ctx(host)) == _read("upload_ms.batch", _ctx(host))
    assert _read("upload_ms.photo", _ctx(host[3:4])) is None


def test_stream_idle_counts_only_idle_time_in_the_callers_hands():
    # the device runs 0-400 and 600-800; the caller holds the stream 300-700 and 900 on
    kernels = [(0.0, 400.0, "conv"), (600.0, 800.0, "conv")]
    host = [(300.0, 700.0, "cv:stream.caller"), (900.0, 1500.0, "cv:stream.caller"), (450.0, 550.0, "cv:fen")]
    ctx = _ctx(host, kernels)
    assert _read("stream_idle_ms.batch", ctx) == pytest.approx((200 + 100) / 1e3 / 2)
    assert _read("stream_idle_ms.batch", _ctx(host[2:], kernels)) is None


def test_the_span_readers_are_found_by_name():
    for metric in ("host_wait_pct.batch", "host_wait_pct.photo", "copy_back_ms.batch", "upload_ms.batch",
                   "upload_ms.photo", "stream_idle_ms.batch"):
        assert _read(metric, _ctx([])) is None
