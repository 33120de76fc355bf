"""Pumps: conjugate Gamma-Poisson hierarchical failure rates.

Reference: doc/examples/pumps.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/pumps.rst; 10000 it, burnin 2500, thin 2, 2 chains):
alpha 0.6968, beta 0.9304, theta[1] 0.0599.
"""

from __future__ import annotations

import numpy as np

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Exponential, Gamma, Poisson
from ..samplers import Slice

Y = np.array([5, 1, 5, 14, 3, 19, 1, 1, 4, 22], dtype=float)
T = np.array([94.3, 15.7, 62.9, 126, 5.24, 31.4, 1.05, 1.05, 2.1, 10.5])
N = 10


def build(seed: int = 0):
    model = Model(
        y=Stochastic(1, lambda theta, t: Poisson(theta * t), monitor=False),
        theta=Stochastic(1, lambda alpha, beta: Gamma(alpha, 1.0 / beta)),
        alpha=Stochastic(lambda: Exponential(1.0)),
        beta=Stochastic(lambda: Gamma(0.1, 1.0)),
    )
    model.set_samplers([
        Slice(["alpha", "beta"], 1.0, form="univariate"),
        Slice("theta", 1.0, form="univariate"),
    ])
    rng = np.random.default_rng(seed)
    inputs = {"t": T}
    inits = [
        {"y": Y, "alpha": 1.0, "beta": 1.0, "theta": rng.gamma(1.0, 1.0, N)},
        {"y": Y, "alpha": 10.0, "beta": 10.0,
         "theta": rng.gamma(10.0, 0.1, N)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/pumps.rst
    "alpha": {"Mean": 0.6968},
    "beta": {"Mean": 0.9304},
    "theta[1]": {"Mean": 0.0599},
    "theta[10]": {"Mean": 1.9884},
}
