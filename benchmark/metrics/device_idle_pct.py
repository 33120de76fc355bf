"""100 less the device's busy share (frozen ``busy_share``) of the
profiled slice after its captures."""


def read(run):
    s = run.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
