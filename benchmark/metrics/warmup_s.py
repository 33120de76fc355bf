"""Host clock around the warm-up ``mcmc`` call (synchronized)."""


def read(run):
    return run.spans.get("warmup_s")
