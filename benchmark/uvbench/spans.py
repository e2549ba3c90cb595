"""Spans the benchmark records around its own calls into the program's
layers, kept in memory for the run.

A span is (name, request id, start, end) on the host's monotonic clock
(`time.perf_counter`, the same in every process of the machine), from any
thread or worker process. A device trace maps them onto its own clock to
say what the host was doing while the device sat idle.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, Optional, Tuple


class Spans:
    """The spans of one run."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, object, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, request: object = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), request)

    def add(self, name: str, start: float, end: float, request: object = None) -> None:
        """A span; one measured in another process passes its own clock readings."""
        with self._lock:
            self.spans.append((name, request, start, end))

    def durations(self, name: str, since: Optional[float] = None) -> List[float]:
        """Seconds of each span named `name`, of those started at `since` or later."""
        return [t1 - t0 for n, _r, t0, t1 in self.spans
                if n == name and (since is None or t0 >= since)]
