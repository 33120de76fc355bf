"""The least bulk ESS among the monitored scalars over the window's draws of
every chain (frozen ``ess_bulk``), over the window's seconds."""


def read(run):
    return run.ess_min / run.window_s
