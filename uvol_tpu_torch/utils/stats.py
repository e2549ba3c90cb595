"""Structured metrics — the observability surface.

The reference's only observability is emoji prints + three callbacks
(SURVEY §5: onMeshBuffering/onFrameShow/onTrackEnd). This module adds the
production-framework version: a process-wide `StatsRegistry` of counters,
gauges, and latency histograms that players, codecs, and the encoder CLI
update, dumpable as one JSON object (`snapshot()`).

Its timers are also spans. While a `torch.profiler` trace runs in the
process (any thread), `STATS.timer(name)` records, besides its
histogram entry, a `Span`: its name, its id, the id of the span open
around it on the same thread (None when it has none: a root), the
thread, and its start and end on `time.perf_counter`. A device trace maps
that clock onto its own through one pair of readings (the benchmark's
`uvbench/trace.py` and `uvbench/program_spans.py`). The spans are kept in
memory, at most `MAX_SPANS`; past that they are counted as dropped.
`spans()` reads them, `reset()` clears them. No span becomes a profiler
range (`record_function`): Kineto would give each one a device-side
event that a trace's busy time would count.

Without a trace a timer costs one flag read beside its histogram entry.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

#: the spans a registry keeps; later ones are counted in `dropped_spans()`
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start: float
    end: float


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "_samples")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: Deque[float] = collections.deque(maxlen=512)  # the newest 512

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._samples.append(v)

    def summary(self) -> Dict:
        s = sorted(self._samples)
        pct = lambda p: s[min(len(s) - 1, int(p * len(s)))] if s else None
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else None,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": pct(0.5),
            "p95": pct(0.95),
        }


class StatsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._spans: List[Span] = []
        self._max_spans = MAX_SPANS
        self._dropped = 0
        self._ids = itertools.count(1)
        self._open = threading.local()  # .stack: ids of this thread's open spans

    def count(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, _Histogram()).observe(value)

    def timer(self, name: str) -> "_Timer":
        """Times a `with` block into histogram `name`; a span besides while
        a profiler trace runs."""
        return _Timer(self, name)

    def spans(self) -> List[Span]:
        """The spans recorded since the last `reset()`, in the order they ended."""
        with self._lock:
            return list(self._spans)

    def dropped_spans(self) -> int:
        """Spans not kept since the last `reset()`: `MAX_SPANS` were held."""
        with self._lock:
            return self._dropped

    def _open_span(self) -> Tuple[int, Optional[int]]:
        stack = self._open.__dict__.setdefault("stack", [])
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        return sid, parent

    def _close_span(self, name: str, sid: int, parent: Optional[int],
                    t0: float, t1: float) -> None:
        self._open.stack.pop()
        with self._lock:
            if len(self._spans) < self._max_spans:
                self._spans.append(Span(name, sid, parent, threading.get_ident(), t0, t1))
            else:
                self._dropped += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": {k: h.summary() for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._spans.clear()
            self._dropped = 0


class _Timer:
    __slots__ = ("_reg", "_name", "_t0", "_span")

    def __init__(self, reg: StatsRegistry, name: str):
        self._reg = reg
        self._name = name

    def __enter__(self) -> "_Timer":
        # torch.profiler sets this module flag for the whole process
        self._span = self._reg._open_span() if _autograd_profiler._is_profiler_enabled else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._reg.observe(self._name, t1 - self._t0)
        if self._span is not None:
            self._reg._close_span(self._name, *self._span, self._t0, t1)


#: process-wide registry (players/codecs/CLI record here)
STATS = StatsRegistry()
