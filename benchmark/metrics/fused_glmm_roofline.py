"""The fused GLMM likelihood kernel's share of its roofline: the least time
an H100 could take for one call of the function (frozen ``glmm_bound_ms``
for the cell's chains, G, n and P at the published peaks and the 1980 MHz
SM clock) over the device time of one call, a call being a run of kernels
named ``glmm_*`` in the profiled slice.  None where no such kernel ran."""

import statistics

from benchmark.frozen.glmm_work import glmm_bound_ms


def read(run):
    s, c = run.slice, run.config
    if s is None:
        return None
    calls = s.kernel_calls(r"\bglmm_\w+")
    if not calls:
        return None
    bound_ms = glmm_bound_ms(c["P"], c["n"], c["G"], run.chains)["bound_ms"]
    return 100.0 * bound_ms / (1e3 * statistics.fmean(calls))
