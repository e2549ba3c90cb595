"""The load generator's arithmetic: the closed loop and its rate.

Closed loop: one request in flight; the next starts when the last ends.
The window runs whole requests: the one in flight at the deadline is
finished and counted, and a rate divides the work of all requests by the
time they actually took, from the window's start to the last one's end.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional


def closed_loop(request: Callable[[int], dict], start: float, deadline: float,
                before: Optional[Callable[[int, float], None]] = None) -> List[dict]:
    """Run `request(i)` back to back from `start` until one ends at or past
    `deadline`; each record gets the request's own `start` and `end`.
    `before(i, now)` runs between requests (the tracer's hook)."""
    records: List[dict] = []
    i, now = 0, start
    while True:
        if before is not None:
            before(i, now)
        t0 = time.perf_counter()
        rec = request(i)
        t1 = time.perf_counter()
        rec.update(start=t0, end=t1)
        records.append(rec)
        i, now = i + 1, t1
        if t1 >= deadline:
            return records


def rate(work: float, start: float, records: List[dict]) -> Optional[float]:
    """Work a second over whole requests: `work` over the time from the
    window's `start` to the last request's end."""
    if not records:
        return None
    return work / (records[-1]["end"] - start)
