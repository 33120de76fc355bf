"""Output / posterior-inference layer (reference src/output/)."""

from .chains import Chains, ModelChains
from .chainsummary import ChainSummary
from .stats import (autocor, autocov, changerate, cor, describe, ess_bulk,
                    ess_rhat, ess_tail, hpd, mcse, quantile, rhat_rank,
                    summarystats)
from .diagnostics import (gelmandiag, gewekediag, heideldiag, pcramer,
                          rafterydiag)
from .fileio import read_chains, readcoda, write_chains
from .modelstats import dic, logpdf_at, logpdf_chains, predict
from . import plot as plots
from .plot import autocorplot, barplot, contourplot, densityplot, draw, \
    meanplot, mixeddensityplot, plot, traceplot

__all__ = [
    "Chains", "ModelChains", "ChainSummary",
    "autocor", "autocov", "changerate", "cor", "describe", "hpd", "mcse",
    "quantile", "summarystats", "ess_bulk", "ess_tail", "ess_rhat",
    "rhat_rank",
    "gelmandiag", "gewekediag", "heideldiag", "rafterydiag", "pcramer",
    "read_chains", "readcoda", "write_chains",
    "dic", "logpdf_at", "logpdf_chains", "predict",
    "plot", "draw", "traceplot", "densityplot", "meanplot", "autocorplot",
    "barplot", "contourplot", "mixeddensityplot",
]
