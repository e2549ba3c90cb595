"""The port's `utils.stats` timers as spans, on the CPU.

Outside a `torch.profiler` trace a timer feeds its histogram alone; inside
one it also records a span with its parent on the same thread. The ETC1S
encoder's timers (`etc1s.*_s`) give one tree per segment, and tracing it
leaves the segment's bytes as they are.
"""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s
from uvol_tpu_torch.utils import stats as tstats


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_timer_outside_a_trace_records_no_span():
    reg = tstats.StatsRegistry()
    with reg.timer("a.x_s"):
        with reg.timer("a.y_s"):
            pass
    timings = reg.snapshot()["timings"]
    assert timings["a.x_s"]["count"] == timings["a.y_s"]["count"] == 1
    assert reg.spans() == [] and reg.dropped_spans() == 0


def test_nested_timers_give_parents_and_lie_within_them():
    reg = tstats.StatsRegistry()
    with _profile():
        with reg.timer("root_s"):
            with reg.timer("a_s"):
                with reg.timer("b_s"):
                    pass
            with reg.timer("a_s"):
                pass
        with reg.timer("root_s"):
            pass
    sp = reg.spans()
    assert [s.name for s in sp] == ["b_s", "a_s", "a_s", "root_s", "root_s"]
    by_id = {s.id: s for s in sp}
    assert len(by_id) == 5
    b, a1, a2, r1, r2 = sp
    assert (b.parent, a1.parent, a2.parent) == (a1.id, r1.id, r1.id)
    assert r1.parent is None and r2.parent is None
    for s in sp:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
    assert r1.end <= r2.start
    assert reg.snapshot()["timings"]["a_s"]["count"] == 2
    reg.reset()
    assert reg.spans() == [] and reg.snapshot()["timings"] == {}


def test_each_thread_keeps_its_own_stack():
    reg = tstats.StatsRegistry()
    both_open = threading.Barrier(2)
    inner_done = threading.Barrier(2)

    def work(tag):
        with reg.timer(f"{tag}.outer_s"):
            both_open.wait()
            with reg.timer(f"{tag}.inner_s"):
                inner_done.wait()

    with _profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("t0", "t1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    sp = {s.name: s for s in reg.spans()}
    assert len(sp) == 4
    for tag in ("t0", "t1"):
        outer, inner = sp[f"{tag}.outer_s"], sp[f"{tag}.inner_s"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.thread == outer.thread
        assert outer.start <= inner.start <= inner.end <= outer.end
    assert sp["t0.outer_s"].thread != sp["t1.outer_s"].thread


def test_the_bound_counts_dropped_spans():
    reg = tstats.StatsRegistry()
    reg._max_spans = 3
    with _profile():
        for _ in range(5):
            with reg.timer("x_s"):
                pass
    assert len(reg.spans()) == 3 and reg.dropped_spans() == 2
    assert reg.snapshot()["timings"]["x_s"]["count"] == 5
    reg.reset()
    assert reg.dropped_spans() == 0


def test_no_timer_becomes_a_profiler_range():
    reg = tstats.StatsRegistry()
    with _profile() as prof:
        with reg.timer("span.never_in_the_trace_s"):
            torch.ones(4).sum()
    assert len(reg.spans()) == 1
    assert not [e for e in prof.events() if "never_in_the_trace" in e.name]


def test_histogram_percentiles_follow_the_newest_samples():
    reg = tstats.StatsRegistry()
    for v in range(1000):
        reg.observe("t_s", float(v))
    t = reg.snapshot()["timings"]["t_s"]
    assert t["count"] == 1000 and t["min"] == 0.0 and t["max"] == 999.0
    # the newest 512 samples are 488..999
    assert t["p50"] == 488.0 + 256 and t["p95"] == 488.0 + int(0.95 * 512)


def _segment() -> np.ndarray:
    """2 RGB frames of 64 x 64: 512 blocks, so a 512/512 build runs the delta stage."""
    rng = np.random.default_rng(24)
    y, x = np.mgrid[0:64, 0:64]
    frames = np.stack([np.stack([(3 * x + 5 * k) % 256, (2 * y + x) % 256,
                                 (x * y // 16 + k) % 256], -1) for k in range(2)])
    return np.clip(frames + rng.integers(-20, 20, frames.shape), 0, 255).astype(np.uint8)


def _encode(frames, min_psnr_db):
    return encode_ktx2_etc1s(frames, num_endpoints=512, num_selectors=512,
                             min_psnr_db=min_psnr_db, device="cpu")


@pytest.mark.parametrize("min_psnr_db", [0.0, 100.0])
def test_etc1s_segment_span_tree(min_psnr_db):
    """One root; a build and a PSNR check per rung taken; per build one core,
    one RDO, 5 relabels and 4 delta passes at lambda > 0 (1 and 0 on the
    last rung, lambda = 0); one emission. 0 dB stops on the first rung,
    100 dB walks the whole ladder of 4."""
    frames = _segment()
    tstats.STATS.reset()
    with _profile():
        _encode(frames, min_psnr_db)
    sp = tstats.STATS.spans()
    tstats.STATS.reset()
    rungs = 1 if min_psnr_db == 0.0 else 4
    last_rung_lambda_zero = rungs == 4
    roots = [s for s in sp if s.name == "etc1s.segment_s"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0]
    by_id = {s.id: s for s in sp}
    builds = [s for s in sp if s.name == "etc1s.build_s"]
    n = Counter(s.name for s in sp)
    assert n["etc1s.build_s"] == n["etc1s.psnr_s"] == rungs
    assert n["etc1s.core_s"] == n["etc1s.rdo_s"] == rungs
    assert n["etc1s.emit_s"] == 1
    per_build = {b.id: Counter(s.name for s in sp if s.parent == b.id) for b in builds}
    want = [{"etc1s.core_s": 1, "etc1s.rdo_s": 1, "etc1s.relabel_s": 5, "etc1s.delta_s": 4}
            for _ in builds]
    if last_rung_lambda_zero:
        want[-1] = {"etc1s.core_s": 1, "etc1s.rdo_s": 1, "etc1s.relabel_s": 1}
    assert [per_build[b.id] for b in sorted(builds, key=lambda s: s.start)] == want
    assert set(n) == {"etc1s.segment_s", "etc1s.build_s", "etc1s.core_s", "etc1s.rdo_s",
                      "etc1s.relabel_s", "etc1s.delta_s", "etc1s.psnr_s", "etc1s.emit_s"}
    for s in sp:
        if s is root:
            continue
        p = by_id[s.parent]
        assert p.start <= s.start <= s.end <= p.end
        assert (p is root) == (s.name in ("etc1s.build_s", "etc1s.psnr_s", "etc1s.emit_s"))
    leaves = sorted((s.start, s.end) for s in sp if s.name not in
                    ("etc1s.segment_s", "etc1s.build_s"))
    assert all(a[1] <= b[0] for a, b in zip(leaves, leaves[1:]))  # leaves never overlap


def test_etc1s_bytes_unchanged_under_a_trace():
    frames = _segment()
    plain = _encode(frames, 100.0)
    tstats.STATS.reset()
    with _profile():
        traced = _encode(frames, 100.0)
    assert tstats.STATS.spans()
    tstats.STATS.reset()
    assert traced == plain
