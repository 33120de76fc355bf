"""The least bulk ESS among the monitored scalars over the kept draws of the
window (chains x iterations)."""


def read(run):
    return run.ess_min / (run.chains * run.iters)
