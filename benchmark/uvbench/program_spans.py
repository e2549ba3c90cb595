"""The program's own spans in a `--trace 1` run, grouped by ETC1S segment.

`uvol_tpu_torch.utils.stats.STATS` records a span for each of its timers
while a profiler trace runs: (name, id, parent id, thread, start, end),
the times on `time.perf_counter`. They are moved onto the trace's clock by
the offset `DeviceTrace.stop` gives the benchmark's own spans,
`run.tracer.started_at - run.summary.window[0]`. Each `etc1s.segment_s`
span that lies wholly inside the traced stretch is one segment; every
span whose chain of parents reaches it is the segment's. Roots that cross
the stretch's edges, and spans that reach no kept root (their root or a
parent began before the trace, or was not kept), are left out.

A program without spans (no `STATS.spans`), or a run without a trace,
gives None: the readers then report nothing.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from uvbench.trace import _merge

ROOT = "etc1s.segment_s"
#: the phases of a segment, each timed where its work happens; they do not
#: overlap, and `etc1s.build_s` holds the first four
LEAVES = ("etc1s.core_s", "etc1s.rdo_s", "etc1s.relabel_s", "etc1s.delta_s",
          "etc1s.psnr_s", "etc1s.emit_s")


@dataclasses.dataclass
class Segment:
    """One root on the trace's clock, and its spans' intervals by name."""

    start: float
    end: float
    spans: Dict[str, List[Tuple[float, float]]]

    def total_s(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ()))


def _program_spans():
    try:
        from uvol_tpu_torch.utils.stats import STATS
    except ImportError:
        return None
    read = getattr(STATS, "spans", None)
    return None if read is None else read()


def segments(run) -> Optional[List[Segment]]:
    """The segments wholly inside the traced stretch, in time order; None
    where there is no trace, no program span or no such segment."""
    s, tracer = run.summary, run.tracer
    if s is None or tracer is None or tracer.started_at is None:
        return None
    spans = _program_spans()
    if not spans:
        return None
    off = tracer.started_at - s.window[0]
    w0, w1 = s.window
    spans = [(n, i, p, t0 - off, t1 - off) for n, i, p, _thread, t0, t1 in spans]
    parent = {i: p for _n, i, p, _a, _b in spans}
    roots = {i: Segment(a, b, defaultdict(list)) for n, i, _p, a, b in spans
             if n == ROOT and a >= w0 and b <= w1}
    for n, i, p, a, b in spans:
        if i in roots:
            continue
        while p is not None and p not in roots:
            p = parent.get(p)
        if p is not None:
            roots[p].spans[n].append((a, b))
    out = sorted(roots.values(), key=lambda g: g.start)
    return out or None


def mean_ms(run, name: str) -> Optional[float]:
    """The mean over the segments of the time under spans `name`, in ms."""
    segs = segments(run)
    if segs is None:
        return None
    return 1e3 * sum(g.total_s(name) for g in segs) / len(segs)


def mean_count(run, name: str) -> Optional[float]:
    """The mean over the segments of the number of spans `name`."""
    segs = segments(run)
    if segs is None:
        return None
    return sum(len(g.spans.get(name, ())) for g in segs) / len(segs)


def idle_unattributed_pct(run) -> Optional[float]:
    """Of the device's idle time inside the segments, the share (%) under
    no leaf span (`LEAVES`)."""
    segs = segments(run)
    if segs is None:
        return None
    s = run.summary
    idle = unattributed = 0.0
    for g in segs:
        seg_idle = (g.end - g.start) - s.busy_in(g.start, g.end)
        leaves = _merge([(max(a, g.start), min(b, g.end)) for n in LEAVES
                         for a, b in g.spans.get(n, ()) if b > g.start and a < g.end])
        leaf_idle = sum((b - a) - s.busy_in(a, b) for a, b in leaves)
        idle += seg_idle
        unattributed += seg_idle - leaf_idle
    return 100.0 * unattributed / idle if idle > 0 else None
