"""Math utilities (reference src/utils.jl:45-81): logit/invlogit and running
means."""

from __future__ import annotations

import numpy as np
import torch


def invlogit(x):
    """1 / (1 + exp(-x)) (reference utils.jl:63-64)."""
    x = torch.as_tensor(x)
    return 1.0 / (torch.exp(-x) + 1.0)


def logit(x):
    """log(x / (1 - x)) (reference utils.jl:66-67)."""
    x = torch.as_tensor(x)
    return torch.log(x / (1.0 - x))


def cummean(x):
    """Running means over the leading axis (reference utils.jl:50-60)."""
    from ..output.stats import cummean_arr
    return cummean_arr(np.asarray(x))
