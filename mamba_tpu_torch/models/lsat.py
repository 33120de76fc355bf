"""LSAT: Rasch one-parameter IRT (1000 examinees x 5 items).

Reference: doc/examples/lsat.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/lsat.rst: 10000 it, burnin 2500, thin 2, 2 chains,
AMWG+Slice): beta 0.8040, a[1] -1.2624, a[3] 1.2421, a[5] -0.6296.

The reference expands 32 distinct response patterns into 1000 rows and
builds a 1000x5 Bernoulli object array (lsat.jl:42-56); here that is one
broadcast (1000, 5) Bernoulli.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Bernoulli, Flat, Normal, Truncated
from ..samplers import AMWG, NUTS, Slice

CULM = np.array([3, 9, 11, 22, 23, 24, 27, 31, 32, 40, 40, 56, 56, 59, 61, 76,
                 86, 115, 129, 210, 213, 241, 256, 336, 352, 408, 429, 602,
                 613, 674, 702, 1000])
RESPONSE = np.array([
    [0,0,0,0,0],[0,0,0,0,1],[0,0,0,1,0],[0,0,0,1,1],[0,0,1,0,0],[0,0,1,0,1],
    [0,0,1,1,0],[0,0,1,1,1],[0,1,0,0,0],[0,1,0,0,1],[0,1,0,1,0],[0,1,0,1,1],
    [0,1,1,0,0],[0,1,1,0,1],[0,1,1,1,0],[0,1,1,1,1],[1,0,0,0,0],[1,0,0,0,1],
    [1,0,0,1,0],[1,0,0,1,1],[1,0,1,0,0],[1,0,1,0,1],[1,0,1,1,0],[1,0,1,1,1],
    [1,1,0,0,0],[1,1,0,0,1],[1,1,0,1,0],[1,1,0,1,1],[1,1,1,0,0],[1,1,1,0,1],
    [1,1,1,1,0],[1,1,1,1,1]], dtype=float)
N = 1000
T = RESPONSE.shape[1]

_counts = np.diff(np.concatenate([[0], CULM]))
R_FULL = np.repeat(RESPONSE, _counts, axis=0)    # (1000, 5)


def build(scheme: str = "reference"):
    model = Model(
        r=Stochastic(2, lambda beta, theta, alpha: Bernoulli(
            torch.sigmoid(beta * theta[:, None] - alpha[None, :])),
            monitor=False),
        theta=Stochastic(1, lambda: Normal(torch.zeros(N), 1.0), monitor=False),
        alpha=Stochastic(1, lambda: Normal(torch.zeros(T), 100.0),
                         monitor=False),
        a=Logical(1, lambda alpha: alpha - torch.mean(alpha)),
        beta=Stochastic(lambda: Truncated(Flat(), 0.0, torch.inf)),
    )
    if scheme == "reference":
        model.set_samplers([
            AMWG("alpha", 0.1),
            Slice("beta", 1.0),
            Slice("theta", 0.5),
        ])
    elif scheme == "nuts":
        model.set_samplers([
            NUTS(["alpha", "theta", "beta"]),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    inputs = {}
    inits = [
        {"r": R_FULL, "alpha": np.zeros(T), "beta": 1.0, "theta": np.zeros(N)},
        {"r": R_FULL, "alpha": np.ones(T), "beta": 2.0, "theta": np.zeros(N)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/lsat.rst (Empirical Posterior Estimates)
    "beta": {"Mean": 0.8040, "SD": 0.0730},
    "a[1]": {"Mean": -1.2624, "SD": 0.1040},
    "a[3]": {"Mean": 1.2421, "SD": 0.0683},
    "a[5]": {"Mean": -0.6296, "SD": 0.0866},
}
