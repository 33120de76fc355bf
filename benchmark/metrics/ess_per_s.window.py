"""The least bulk ESS among the monitored scalars over the draws of the
traced run's unprofiled restart, over its wall seconds: ``ess_per_s`` where
its spread over seeds is too wide for a bound."""


def read(run):
    return run.ess_min_plain / run.plain["seconds"]
