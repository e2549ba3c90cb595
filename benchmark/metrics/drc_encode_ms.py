"""Draco encoder: one frame's `encode_drc` in a worker of the spawned pool, on the worker's own clock.

Read from the benchmark's spans around that call, every one that started
inside the measured window (host clock); the median, in ms."""

import statistics


def read(run):
    d = run.spans.durations("drc_encode", since=run.start)
    return statistics.median(d) * 1e3 if d else None
