"""Structured metrics/logging — the observability surface.

The reference's only observability is emoji prints + three callbacks
(SURVEY §5: onMeshBuffering/onFrameShow/onTrackEnd). This module adds the
production-framework version: a process-wide `StatsRegistry` of counters,
gauges, and latency histograms that players, codecs, and the encoder CLI
update, dumpable as one JSON object (and optionally streamed as JSON lines
to a file via `UVT_STATS_LOG=path`).

The port's copy of `uvol_tpu/utils/stats.py`, unchanged: the
port's player and `.drc` decoder record into their own `STATS`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "_samples")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []  # reservoir (first 512)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._samples) < 512:
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
        self._log_path = os.environ.get("UVT_STATS_LOG")

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
        return _Timer(self, name)

    def event(self, name: str, **fields) -> None:
        """Structured JSON-lines event (when UVT_STATS_LOG is set)."""
        self.count(f"events.{name}")
        if self._log_path:
            rec = {"ts": time.time(), "event": name, **fields}
            with self._lock, open(self._log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

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


class _Timer:
    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: StatsRegistry, name: str):
        self._reg = reg
        self._name = name

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._reg.observe(self._name, time.perf_counter() - self._t0)


#: process-wide registry (players/codecs/CLI record here)
STATS = StatsRegistry()
