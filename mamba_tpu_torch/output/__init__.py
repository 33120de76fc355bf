"""Output / posterior-inference layer (reference src/output/)."""

from .chains import Chains, ModelChains
from .chainsummary import ChainSummary
from .stats import (autocor, autocov, changerate, cor, describe, ess_bulk,
                    ess_rhat, ess_tail, hpd, mcse, quantile, rhat_rank,
                    summarystats)

__all__ = [
    "Chains", "ModelChains", "ChainSummary",
    "autocor", "autocov", "changerate", "cor", "describe", "hpd", "mcse",
    "quantile", "summarystats", "ess_bulk", "ess_tail", "ess_rhat",
    "rhat_rank",
]
