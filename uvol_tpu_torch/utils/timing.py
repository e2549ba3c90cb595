"""Wall-clock and device timing — counterpart of `uvol_tpu/utils/timing.py`.

`Timer` and `StageTimer` are the reference's host timers, copied;
`cuda_timer` times a region of queued GPU work with CUDA events;
`median_cuda_ms` repeats a callable; `device_trace` wraps a region in a
`torch.profiler` trace and `device_time_ms` sums its device-side events
by name. The device timers need a card: a measurement that finds none
raises rather than timing the CPU.

`device_trace` starts every trace on a fresh CUPTI. Kept subscribed from
one trace to the next, CUPTI stamped the device records of an H100 with
times that fell further outside Kineto's trace window the longer ago the
process's first trace was: some records of a trace were dropped ~10 s
after it, all of them 80 s after it, with the card idle or busy. With
`TEARDOWN_CUPTI=1` Kineto tears CUPTI down when a trace stops, on a thread
of its own that waits for the next CUDA call; were that call inside the
next trace, that trace came back empty. So the helper makes that call
itself, one spin kernel waited for with a pause on each side, before the
trace and after it (`examples/torch_profiler_after_cli.py` has the series
that show both).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch


class Timer:
    """Simple restartable wall-clock timer reporting milliseconds."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def restart(self) -> None:
        self._start = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1e3


class StageTimer:
    """Accumulates wall time per named stage; cheap enough to always be on."""

    def __init__(self) -> None:
        self.totals_ms: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals_ms[name] += (time.perf_counter() - t0) * 1e3
            self.counts[name] += 1

    def report(self) -> List[str]:
        lines = []
        for name in sorted(self.totals_ms, key=self.totals_ms.get, reverse=True):
            n = self.counts[name]
            tot = self.totals_ms[name]
            lines.append(f"{name:32s} {tot:10.2f} ms total  {tot / max(n, 1):8.3f} ms/call  x{n}")
        return lines

    def __str__(self) -> str:
        return "\n".join(self.report())


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card")


class Elapsed:
    """Filled in when the `cuda_timer` block exits."""

    ms: float = float("nan")


@contextlib.contextmanager
def cuda_timer() -> Iterator[Elapsed]:
    """Time the GPU work queued inside the block, in milliseconds.

    Synchronizes first, so earlier work is not counted, and waits for
    the end event on exit."""
    _require_cuda()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    res = Elapsed()
    start.record()
    yield res
    end.record()
    end.synchronize()
    res.ms = start.elapsed_time(end)


def median_cuda_ms(fn: Callable[[], object], reps: int = 5, warmup: int = 1
                   ) -> float:
    """Median over `reps` timed calls of `fn` after `warmup` untimed ones."""
    for _ in range(warmup):
        fn()
    times: List[float] = []
    for _ in range(reps):
        with cuda_timer() as t:
            fn()
        times.append(t.ms)
    return statistics.median(times)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Wrap a region in a `torch.profiler` trace (CPU + CUDA activities).
    The Chrome trace is written under `log_dir` when one is given; read
    the device time with `device_time_ms` after the block. CUPTI is torn
    down after the trace unless `TEARDOWN_CUPTI` is set otherwise (see the
    module's docstring), and that teardown is done before the block and
    after it, outside the trace and any region timed next."""
    _require_cuda()
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    _settle_cupti()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    handler = torch.profiler.tensorboard_trace_handler(log_dir) if log_dir else None
    with torch.profiler.profile(activities=acts, on_trace_ready=handler) as prof:
        yield prof
        torch.cuda.synchronize()
    _settle_cupti()


#: the pause before and after `_settle_cupti`'s kernel, for Kineto's
#: teardown thread to be waiting for the call and then to be done with it
SETTLE_S = 0.05


def _settle_cupti() -> None:
    """One spin kernel, waited for: Kineto finishes a CUPTI teardown left
    by the last trace at the next CUDA call, and this is that call."""
    time.sleep(SETTLE_S)
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def device_time_ms(prof) -> Dict[str, float]:
    """Milliseconds of device-side events (kernels, memcopies, memsets)
    per event name in a finished trace; host-side ops are left out, so
    nothing is counted twice."""
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out
