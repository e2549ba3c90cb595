"""The load generator's arithmetic, and the trace's."""

import time

import pytest

from uvbench import loops
from uvbench.trace import TraceSummary


def test_closed_loop_finishes_the_request_past_the_deadline():
    """The request in flight at the deadline is finished and counted, and the
    rate divides by the time actually taken."""
    start = time.perf_counter()
    recs = loops.closed_loop(lambda i: (time.sleep(0.03), {"frames": 5})[1], start, start + 0.1)
    assert len(recs) in (4, 5)
    assert recs[-1]["end"] >= start + 0.1 and recs[-2]["end"] < start + 0.1
    fps = loops.rate(sum(r["frames"] for r in recs), start, recs)
    assert fps == pytest.approx(5 * len(recs) / (recs[-1]["end"] - start))
    assert fps < 5 * len(recs) / 0.1


def test_rate_of_a_hand_worked_window():
    recs = [{"start": 0.0, "end": 0.4}, {"start": 0.4, "end": 1.25}]
    assert loops.rate(500, 0.0, recs) == pytest.approx(400.0)
    assert loops.rate(1, 0.0, []) is None


def test_trace_busy_idle_and_breakdown():
    dev = [("k1", 1.0, 1.2), ("copy", 1.1, 1.5), ("k1", 2.0, 2.1), ("late", 3.9, 4.5)]
    spans = [("encode", 0.5, 3.0), ("segment", 1.6, 1.95)]
    s = TraceSummary(dev, spans, (1.0, 4.0))
    assert s.window_s == pytest.approx(3.0)
    assert s.busy_s == pytest.approx(0.5 + 0.1 + 0.1)
    assert s.kernels("k1") == pytest.approx([0.2, 0.1])
    assert s.busy_in(1.4, 2.05) == pytest.approx(0.1 + 0.05)
    b = s.breakdown()
    assert dict(b["device_ops"]) == pytest.approx({"k1": 0.3, "copy": 0.4, "late": 0.1})
    gaps = dict(b["idle_gaps"])
    # a gap goes whole to the innermost span around its middle
    assert gaps == pytest.approx({"host in segment": 0.5, "host in encode": 1.8})
    s2 = TraceSummary(dev, [("encode", 0.5, 2.5)], (1.0, 4.0))
    assert dict(s2.breakdown()["idle_gaps"]) == pytest.approx({"host in encode": 0.5,
                                                              "host outside spans": 1.8})
