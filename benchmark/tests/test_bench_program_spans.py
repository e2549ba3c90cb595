"""The readers of the program's ETC1S spans on a synthetic trace: the clock
offset, roots across the traced stretch's edge, orphans, the unattributed
share, and a program that records no span."""

import types

import pytest

from uvbench import harness, program_spans
from uvbench.trace import TraceSummary

CELL = "v2-etc1s-1k.encode"
NEW = ("etc1s_core_ms", "etc1s_rdo_ms", "etc1s_relabel_ms", "etc1s_delta_ms", "etc1s_psnr_ms",
       "etc1s_emit_ms", "etc1s_builds", "etc1s_idle_unattributed_pct")
#: the host clock reads 5000.0 where the trace's clock reads 100.0
OFF = 4900.0


def _spans():
    """(name, id, parent, thread, start, end) on the host clock."""
    return [
        # segment A, 101-103 on the trace's clock: every moment under a leaf
        ("etc1s.core_s", 3, 2, 1, 5001.0, 5001.5),
        ("etc1s.rdo_s", 4, 2, 1, 5001.5, 5002.0),
        ("etc1s.relabel_s", 5, 2, 1, 5002.0, 5002.5),
        ("etc1s.build_s", 2, 1, 1, 5001.0, 5002.5),
        ("etc1s.psnr_s", 6, 1, 1, 5002.5, 5002.7),
        ("etc1s.emit_s", 7, 1, 1, 5002.7, 5003.0),
        ("etc1s.segment_s", 1, None, 1, 5001.0, 5003.0),
        # segment B, 104-106, under a span of the caller's that crosses the stretch;
        # 105-105.5 under no leaf
        ("etc1s.core_s", 12, 11, 1, 5004.0, 5005.0),
        ("etc1s.build_s", 11, 10, 1, 5004.0, 5005.0),
        ("etc1s.emit_s", 13, 10, 1, 5005.5, 5006.0),
        ("etc1s.segment_s", 10, 77, 1, 5004.0, 5006.0),
        # orphans: a parent never recorded, and none at all
        ("etc1s.core_s", 20, 999, 1, 5007.0, 5007.5),
        ("etc1s.delta_s", 21, None, 2, 5007.0, 5008.0),
        # segment C, 109.5-110.5, crosses the stretch's end
        ("etc1s.core_s", 31, 30, 1, 5009.5, 5010.0),
        ("etc1s.build_s", 32, 30, 1, 5009.5, 5010.0),
        ("etc1s.segment_s", 30, 77, 1, 5009.5, 5010.5),
        ("cli.texture.etc1s-tpu_s", 77, None, 1, 4990.0, 5020.0),
    ]


def _run():
    dev = [("k", 101.2, 101.4), ("k", 102.6, 102.7), ("k", 104.0, 104.5), ("k", 105.2, 105.3),
           ("k", 109.6, 109.9)]
    return types.SimpleNamespace(summary=TraceSummary(dev, [], (100.0, 110.0)),
                                 tracer=types.SimpleNamespace(started_at=100.0 + OFF))


@pytest.fixture
def readers():
    cell = harness.load_cell(CELL)
    assert set(NEW) <= set(cell.readers)
    return cell.readers


@pytest.fixture
def program(monkeypatch):
    from uvol_tpu_torch.utils.stats import STATS

    monkeypatch.setattr(STATS, "spans", _spans)


def test_segments_on_the_trace_clock(program):
    segs = program_spans.segments(_run())
    assert [(g.start, g.end) for g in segs] == [pytest.approx((101.0, 103.0)),
                                                 pytest.approx((104.0, 106.0))]
    a, b = segs
    assert a.spans["etc1s.core_s"] == [pytest.approx((101.0, 101.5))]
    assert sorted(b.spans) == ["etc1s.build_s", "etc1s.core_s", "etc1s.emit_s"]
    # the orphans and the segment across the edge are nobody's
    assert sum(len(v) for g in segs for v in g.spans.values()) == 6 + 3


def test_phase_readers(program, readers):
    run = _run()
    want = {"etc1s_core_ms": 750.0, "etc1s_rdo_ms": 250.0, "etc1s_relabel_ms": 250.0,
            "etc1s_delta_ms": 0.0, "etc1s_psnr_ms": 100.0, "etc1s_emit_ms": 400.0,
            "etc1s_builds": 1.0}
    for name, v in want.items():
        assert readers[name].read(run) == pytest.approx(v, abs=1e-6), name


def test_unattributed_share(program, readers):
    # idle: A 2.0 - 0.3, all under leaves; B 2.0 - 0.6, of it 0.5 - 0.1 under no leaf
    got = readers["etc1s_idle_unattributed_pct"].read(_run())
    assert got == pytest.approx(100.0 * 0.4 / (1.7 + 1.4))


def test_a_root_across_the_edge_is_left_out(program, monkeypatch):
    from uvol_tpu_torch.utils.stats import STATS

    inside = [s for s in _spans() if s[1] not in (1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13)]
    monkeypatch.setattr(STATS, "spans", lambda: inside)
    assert program_spans.segments(_run()) is None


def test_no_span_reads_nothing(readers, monkeypatch):
    """A program without `STATS.spans` (the parent's), one with no span, and
    a run without a trace: every reader gives None and none raises."""
    from uvol_tpu_torch.utils import stats

    run = _run()
    monkeypatch.setattr(stats, "STATS", types.SimpleNamespace())
    assert all(readers[n].read(run) is None for n in NEW)
    monkeypatch.setattr(stats, "STATS", types.SimpleNamespace(spans=lambda: []))
    assert all(readers[n].read(run) is None for n in NEW)
    run.summary = None
    assert all(readers[n].read(run) is None for n in NEW)
