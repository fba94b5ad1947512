"""What a ``torch.profiler`` trace of a slice of requests holds, reduced to
what the per-layer readers need.

- device intervals (kernels, copies, fills) and their union: the device is
  busy where any stream runs something, so overlapping intervals count
  once (``union``); summing each event's device time would count two
  streams' overlap twice;
- the window: from the start of the first ``bench:request`` span to the
  end of the last (the last span ends after a device synchronize);
- host spans ``bench:<layer>`` that the harness wraps around the calls
  into each layer, and CUDA launch calls on the host;
- the breakdown: the device operations that took most time and the
  longest idle gaps of the device, each named by what the host was doing.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Iterable

SPAN_PREFIX = "bench:"
REQUEST_SPAN = SPAN_PREFIX + "request"
# the profiler's own bookkeeping on the host
PROFILER_OWN = frozenset({"Activity Buffer Request"})
LAUNCH_CALLS = frozenset(
    {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
     "cudaLaunchCooperativeKernel"}
)


def union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def covered(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the part of [lo, hi] inside disjoint ``intervals``."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in intervals)


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] outside disjoint sorted ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def overlap_share(copies: list[tuple[float, float]], kernels: list[tuple[float, float]]) -> float | None:
    """Percent of the copies' summed time that lies under the union of the
    kernels' intervals; None without copies."""
    total = sum(b - a for a, b in copies)
    if total <= 0:
        return None
    merged = union(kernels)
    return 100.0 * sum(covered(merged, a, b) for a, b in copies) / total


@dataclass
class TraceData:
    """One profiled slice, times in microseconds on the profiler's clock."""

    kernels: list[tuple[float, float, str]] = field(default_factory=list)
    copies: list[tuple[float, float, str]] = field(default_factory=list)  # memcpy and memset
    host: list[tuple[float, float, str]] = field(default_factory=list)  # host ops and spans
    window: tuple[float, float] = (0.0, 0.0)
    launches: int = 0
    requests: int = 0
    boards: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        spans = [(max(a, lo), min(b, hi)) for a, b, _ in self.kernels + self.copies if b > lo and a < hi]
        return union(spans)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, names: Iterable[str]) -> float:
        """Summed device seconds of the kernels whose name contains any of
        ``names``."""
        keys = tuple(names)
        return sum(b - a for a, b, n in self.kernels if any(k in n for k in keys)) / 1e6

    def span_s(self, label: str) -> float:
        """Summed host seconds of the harness's ``bench:<label>`` spans."""
        name = SPAN_PREFIX + label
        return sum(b - a for a, b, n in self.host if n == name) / 1e6

    def h2d_under_kernels_pct(self) -> float | None:
        h2d = [(a, b) for a, b, n in self.copies if "htod" in n.lower()]
        return overlap_share(h2d, [(a, b) for a, b, _ in self.kernels])

    def breakdown(self, top: int = 10) -> dict[str, list[list[Any]]]:
        """``device_ops``: the device operations with the most summed time;
        ``idle_gaps``: the longest idle gaps of the window, each named by the
        innermost host operation running at its middle, under the harness
        span that holds it."""
        by_name: dict[str, float] = defaultdict(float)
        for a, b, n in self.kernels + self.copies:
            by_name[_short(n)] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        idle = sorted(gaps(self.busy_intervals(), lo, hi), key=lambda g: g[0] - g[1])[:top]
        named = [[self._doing((a + b) / 2), (b - a) / 1e6] for a, b in idle]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}

    def _doing(self, t: float) -> str:
        inner, outer = None, None
        for a, b, n in self.host:
            if a <= t <= b and n != REQUEST_SPAN:
                if n.startswith(SPAN_PREFIX):
                    if outer is None or b - a < outer[1] - outer[0]:
                        outer = (a, b, n)
                elif inner is None or b - a < inner[1] - inner[0]:
                    inner = (a, b, n)
        where = outer[2][len(SPAN_PREFIX):] if outer else "harness"
        return f"{where}>{_short(inner[2]) if inner else 'python'}"


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template and argument lists."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for cut in ("(", "<"):
        head = name.split(cut, 1)[0]
        if head:
            name = head
    return name.strip()[:80]


def from_profiler(prof: Any, requests: int, boards: int) -> TraceData:
    """Reduce a finished ``torch.profiler.profile`` to a ``TraceData``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    data = TraceData(requests=requests, boards=boards)
    req: list[tuple[float, float]] = []
    for e in prof.events():
        a, b, name = float(e.time_range.start), float(e.time_range.end), e.name
        if e.device_type == cuda:
            if e.is_user_annotation:
                continue  # a span's mirror on the device's timeline, not device work
            low = name.lower()
            (data.copies if ("memcpy" in low or "memset" in low) else data.kernels).append((a, b, name))
            continue
        if name in LAUNCH_CALLS:
            data.launches += 1
            continue
        if name in PROFILER_OWN:
            continue
        if name == REQUEST_SPAN:
            req.append((a, b))
        data.host.append((a, b, name))
    if req:
        data.window = (min(a for a, _ in req), max(b for _, b in req))
    return data
