"""ETC1S encoder: the device's busy time inside one `encode_ktx2_etc1s`
call (the union of its kernels, copies and memsets within the call's
span, from the trace), the mean over the calls wholly inside the traced
stretch, in ms. Beside `etc1s_segment_ms` it says how much of a segment
the card does."""


def read(run):
    s = run.summary
    if s is None:
        return None
    w0, w1 = s.window
    spans = [(a, b) for a, b in s.span_ranges("etc1s_segment") if a >= w0 and b <= w1]
    if not spans:
        return None
    return 1e3 * sum(s.busy_in(a, b) for a, b in spans) / len(spans)
