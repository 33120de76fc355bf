"""Kept draws of all chains in the window, over the window's seconds (host
clock around ``mcmc(sim, K)``, which ends with the draws on the host)."""


def read(run):
    return run.chains * run.iters / run.window_s
