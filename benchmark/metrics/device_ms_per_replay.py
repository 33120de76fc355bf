"""Device milliseconds (the union of kernel, copy and fill intervals) of
the profiled slice after its captures, over the graph replays launched in
it."""


def read(run):
    s = run.slice
    if s is None or not s.replays:
        return None
    return 1e3 * s.busy_s / s.replays
