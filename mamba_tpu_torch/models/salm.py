"""Salm: extra-Poisson variation in a salmonella assay (3 plates x 6 doses).

Reference: doc/examples/salm.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/salm.rst; 10000 it, burnin 2500, thin 2, 2 chains):
alpha 2.010, beta 0.3543, gamma -0.001125, s2 0.0691.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import InverseGamma, Normal, Poisson
from ..samplers import AMWG, Slice

# (3 plates, 6 doses), column-major reshape of salm.jl:5-7
Y = np.array([15, 21, 29, 16, 18, 21, 16, 26, 33, 27, 41, 60, 33, 38, 41,
              20, 27, 42], dtype=float).reshape(6, 3).T
X = np.array([0.0, 10.0, 33.0, 100.0, 333.0, 1000.0])


def build():
    model = Model(
        y=Stochastic(2, lambda alpha, beta, gamma, x, lam: Poisson(
            torch.exp(alpha + beta * torch.log(x + 10.0)[None, :]
                    + gamma * x[None, :] + lam)), monitor=False),
        alpha=Stochastic(lambda: Normal(0.0, 1000.0)),
        beta=Stochastic(lambda: Normal(0.0, 1000.0)),
        gamma=Stochastic(lambda: Normal(0.0, 1000.0)),
        lam=Stochastic(2, lambda s2: Normal(torch.zeros((3, 6)),
                                            torch.sqrt(s2)), monitor=False),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([
        Slice(["alpha", "beta", "gamma"], [1.0, 1.0, 0.1]),
        AMWG(["lam", "s2"], 0.1),
    ])
    inputs = {"x": X}
    inits = [
        {"y": Y, "alpha": 0.0, "beta": 0.0, "gamma": 0.0, "s2": 10.0,
         "lam": np.zeros((3, 6))},
        {"y": Y, "alpha": 1.0, "beta": 1.0, "gamma": 0.01, "s2": 1.0,
         "lam": np.zeros((3, 6))},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/salm.rst
    "alpha": {"Mean": 2.010},
    "beta": {"Mean": 0.3543},
    "gamma": {"Mean": -0.001125},
    "s2": {"Mean": 0.0691},
}
