"""Device: the share of the traced stretch of the window in which no
operation ran on the device (100 x (1 - busy / window)), from the trace.
In the encode cell; moves encode_fps."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or not s.events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
