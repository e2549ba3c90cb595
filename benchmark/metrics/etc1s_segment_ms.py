"""ETC1S encoder: one `encode_ktx2_etc1s` call on a 5-layer segment at the configuration's palettes.

Read from the benchmark's spans around that call, every one that started
inside the measured window (host clock); the median, in ms."""

import statistics


def read(run):
    d = run.spans.durations("etc1s_segment", since=run.start)
    return statistics.median(d) * 1e3 if d else None
