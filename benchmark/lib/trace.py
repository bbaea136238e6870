"""Spans around the calls into the program, and the reading of a traced
window from torch.profiler's trace.

``Spans`` times each named call on the host clock (its total and count);
in a traced run each span is also a ``record_function`` range named
``bench.<name>``, so the trace shows what the host was doing. ``read``
turns the profiler's events into a ``Trace``: the device's activity
(kernels, copies, sets) inside the window span ``bench.window``, its busy
time as the union of those intervals, the device time of kernels by name,
of host-to-device copies, the device operations that took most time, and
the longest idle gaps, each named by the innermost span the host was in
when it began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "bench."


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            ctx = record_function(PREFIX + name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]            # device seconds by kernel name
    h2d_s: float                          # device seconds of host-to-device copies
    device_ops: List[Tuple[str, float]]   # the 10 longest, by total seconds
    idle_gaps: List[Tuple[str, float]]    # the 10 longest, each named by the host's span

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose names contain one of `names`."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def read(prof) -> Optional[Trace]:
    """The traced window of `prof`; None when the trace holds no window
    span or no device activity in it."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.device_type == DeviceType.CPU and e.name == PREFIX + "window"]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = sorted(((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(PREFIX) and e.name != PREFIX + "window"))
    device = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(PREFIX):
            continue
        if e.name.startswith("ProfilerStep"):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            device.append((s, t, e.name))
    if not device:
        return None
    busy = _union([(s, t) for s, t, _ in device])
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in device:
        by_name[name] += (t - s) / 1e6
    h2d = sum(v for k, v in by_name.items() if k.startswith("Memcpy HtoD"))
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_host_at(spans, a), (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(((k[:120], v) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(t - s for s, t in busy) / 1e6,
                 kernel_s=dict(by_name), h2d_s=h2d, device_ops=ops[:10], idle_gaps=gaps[:10])


def _host_at(spans, t: float) -> str:
    """The innermost span (the latest begun) that holds time t."""
    name = "host"
    for s, e, n in spans:
        if s > t:
            break
        if e >= t:
            name = n
    return name
