"""Host cost of one `utils.stats` timer's enter and exit, without and with a trace.

    python3 examples/torch_stats_timer_cost.py [ROOT]

Imports `uvol_tpu_torch` from ROOT (default: this checkout), so that one
process run per tree compares two trees on one machine. Times `LOOPS`
iterations of `with reg.timer(name): pass` on a fresh `StatsRegistry`, the
empty loop's time taken off, `REPS` times, and prints one JSON object with
the median nanoseconds per timer: with no profiler running (`off`), and
inside a `torch.profiler` trace of CPU activity (`on`), where a tree with
spans records one per timer (its registry's bound raised so that none is
dropped). Runs on the CPU; a CUDA card is not used.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

LOOPS = 20_000
REPS = 7


def per_timer_ns(reg, loops: int) -> float:
    t0 = time.perf_counter()
    for _ in range(loops):
        pass
    empty = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(loops):
        with reg.timer("bench.timer_s"):
            pass
    return (time.perf_counter() - t0 - empty) / loops * 1e9


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    from uvol_tpu_torch.utils import stats

    def fresh():
        reg = stats.StatsRegistry()
        if hasattr(reg, "_max_spans"):
            reg._max_spans = LOOPS * REPS * 2
        return reg

    per_timer_ns(fresh(), LOOPS)  # warm-up
    off = [per_timer_ns(fresh(), LOOPS) for _ in range(REPS)]
    on = []
    reg = None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(REPS):
            reg = fresh()
            on.append(per_timer_ns(reg, LOOPS))
    spans = len(reg.spans()) if hasattr(reg, "spans") else None
    print(json.dumps({"root": root, "torch": torch.__version__, "loops": LOOPS, "reps": REPS,
                      "off_ns": statistics.median(off), "on_ns": statistics.median(on),
                      "off_ns_all": off, "on_ns_all": on, "spans_last_rep": spans}))


if __name__ == "__main__":
    main()
