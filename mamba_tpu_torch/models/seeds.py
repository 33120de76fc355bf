"""Seeds: hierarchical logistic regression with per-group random effects.

Reference: doc/examples/seeds.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/seeds.rst:42-48; 12500 it, burnin 2500, thin 2,
2 chains, AMM+AMWG): alpha0 -0.5562, alpha12 -0.7464, s2 0.0857.

The reference's per-plate ``Binomial(n[i], invlogit(...))`` object array
(seeds.jl:19-29) is one batched Binomial with a logistic link here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Binomial, InverseGamma, Normal
from ..samplers import AMM, AMWG, NUTS, Slice

R = np.array([10, 23, 23, 26, 17, 5, 53, 55, 32, 46, 10, 8, 10, 8, 23, 0, 3,
              22, 15, 32, 3], dtype=float)
NTRIALS = np.array([39, 62, 81, 51, 39, 6, 74, 72, 51, 79, 13, 16, 30, 28, 45,
                    4, 12, 41, 30, 51, 7], dtype=float)
X1 = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
              dtype=float)
X2 = np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1],
              dtype=float)
N = 21


def build(scheme: str = "reference"):
    model = Model(
        r=Stochastic(1, lambda alpha0, alpha1, alpha2, alpha12, b, x1, x2, n:
                     Binomial(n, torch.sigmoid(
                         alpha0 + alpha1 * x1 + alpha2 * x2
                         + alpha12 * x1 * x2 + b)), monitor=False),
        b=Stochastic(1, lambda s2: Normal(torch.zeros(N), torch.sqrt(s2)),
                     monitor=False),
        alpha0=Stochastic(lambda: Normal(0.0, 1000.0)),
        alpha1=Stochastic(lambda: Normal(0.0, 1000.0)),
        alpha2=Stochastic(lambda: Normal(0.0, 1000.0)),
        alpha12=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    if scheme == "reference":
        model.set_samplers([
            AMM(["alpha0", "alpha1", "alpha2", "alpha12"], 0.01 * np.eye(4)),
            AMWG("b", 0.01),
            AMWG("s2", 0.1),
        ])
    elif scheme == "nuts":
        model.set_samplers([
            NUTS(["alpha0", "alpha1", "alpha2", "alpha12", "b"]),
            Slice("s2", 0.5, form="univariate"),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    inputs = {"x1": X1, "x2": X2, "n": NTRIALS}
    inits = [
        {"r": R, "alpha0": 0.0, "alpha1": 0.0, "alpha2": 0.0, "alpha12": 0.0,
         "s2": 0.01, "b": np.zeros(N)},
        {"r": R, "alpha0": 0.0, "alpha1": 0.0, "alpha2": 0.0, "alpha12": 0.0,
         "s2": 1.0, "b": np.zeros(N)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/seeds.rst:42-48
    "alpha0": {"Mean": -0.5562},
    "alpha12": {"Mean": -0.7464},
    "s2": {"Mean": 0.0857},
}
