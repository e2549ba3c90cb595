"""The device trace of a `--trace 1` run and what the readers take from it.

`DeviceTrace` runs one `torch.profiler` trace (CPU and CUDA activities)
over a stretch of the window, with the benchmark's own copy of the CUPTI
workaround that `uvol_tpu_torch/utils/timing.device_trace` uses on the
H100 machines: kept subscribed from one trace to the next, CUPTI stamped
device records further outside Kineto's window the longer ago the
process's first trace was, and some records were dropped ~10 s after it.
With `TEARDOWN_CUPTI=1` Kineto tears CUPTI down when a trace stops, on a
thread that waits for the next CUDA call; `_settle_cupti` makes that call
itself, a spin kernel waited for with a pause on each side, before the
trace and after it. The traced stretch is kept under `MAX_TRACE_S`, inside
the span of time in which traces were seen whole.

`TraceSummary` holds the device's events (kernels, copies, memsets) and
the benchmark's spans, moved onto the profiler's clock by the offset
between the trace's window mark and the host clock read beside it:
busy time (the union of device intervals), the window, each kernel's
launches and time, device busy inside given spans, and the breakdown of
device time by operation and of idle time by the span the host was in.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

#: the longest traced stretch (s): traces were whole up to ~11 s after CUPTI
#: was subscribed on the H100 machines
MAX_TRACE_S = 6.0
#: the pause before and after the settling kernel
SETTLE_S = 0.05
WINDOW_MARK = "bench:trace_window"


def _settle_cupti() -> None:
    time.sleep(SETTLE_S)
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(merged: List[Tuple[float, float]], a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


class TraceSummary:
    """What one trace holds, in seconds, on the profiler's clock."""

    def __init__(self, device_events: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], window: Tuple[float, float]):
        self.window = window
        w0, w1 = window
        self.events = [(n, max(a, w0), min(b, w1)) for n, a, b in device_events
                       if b > w0 and a < w1]
        self.spans = spans
        self.merged = _merge([(a, b) for _n, a, b in self.events])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged)

    def kernels(self, fragment: str) -> List[float]:
        """Seconds of each device event whose name holds `fragment`."""
        return [b - a for n, a, b in self.events if fragment in n]

    def span_ranges(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == name]

    def busy_in(self, a: float, b: float) -> float:
        return _overlap(self.merged, a, b)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for n, a, b in self.events:
            ops[n[:96]] += b - a
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.window[0]] + [x for iv in self.merged for x in iv] + [self.window[1]]
        spans = sorted((x, y, n) for n, x, y in self.spans)
        active: List[Tuple[float, float, str]] = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):  # gaps in time order
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(spans) and spans[i][0] <= mid:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] >= mid]
            # the innermost span the host was in: the shortest of those around the gap
            label = min(active, key=lambda s: s[1] - s[0])[2] if active else None
            gaps["host in " + label if label else "host outside spans"] += b - a
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(ops), "idle_gaps": order(gaps)}


class DeviceTrace:
    """One trace: `start()` and `stop()` from the thread that drives the
    window; `summary` is filled by `stop()`."""

    def __init__(self) -> None:
        self.prof = None
        self.mark = None
        self.summary: Optional[TraceSummary] = None
        self.started_at: Optional[float] = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    @staticmethod
    def prime() -> None:
        """One empty trace, in set-up: the first trace of a process loads and
        sets up CUPTI, seconds that would otherwise fall in the window."""
        t = DeviceTrace()
        t.start()
        t.stop()

    def start(self) -> None:
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        _settle_cupti()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()
        self.started_at = time.perf_counter()

    def stop(self, host_spans=()) -> None:
        """Stop the trace and summarize it with `host_spans`, (name, request,
        start, end) on the host clock."""
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        _settle_cupti()
        dev, window = [], None
        for e in self.prof.events():
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name != WINDOW_MARK:  # the mark's own device-side range
                    dev.append((e.name, a, b))
            elif e.name == WINDOW_MARK:
                window = (a, b)
        if window is None:
            raise RuntimeError("the trace lost its window mark")
        self.prof = None
        off = self.started_at - window[0]
        spans = [(n, t0 - off, t1 - off) for n, _r, t0, t1 in host_spans]
        self.summary = TraceSummary(dev, spans, window)
