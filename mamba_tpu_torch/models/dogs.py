"""Dogs: Solomon-Wynne avoidance learning, log-linear Bernoulli (30 x 24).

Reference: doc/examples/dogs.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/dogs.rst: 10000 it, burnin 2500, thin 2, 2 chains,
Slice): alpha -0.2442, A 0.7836, beta -0.0789, B 0.9242.

The reference models avoidance probability as ``p = exp(alpha*xa + beta*xs)``
with improper ``Truncated(Flat(), -Inf, -1e-5)`` priors keeping the
exponents negative (dogs.jl:52-70); the 30x24 Bernoulli object array is one
batched Bernoulli here.  xa = cumulative avoidances, xs = cumulative shocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Bernoulli, Flat, Truncated
from ..samplers import Slice

YRAW = np.array([
    [0,0,1,0,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,1,1,0,1,1,0,0,1,1,0,1,0,1,1,1,1,1,1,1,1],
    [0,1,1,0,0,1,1,1,1,0,1,0,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,1,1,1,1,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,1,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,1,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,1,0,1,0,1,1,0,1,0,0,0,1,1,1,1,1,0,1,1,0],
    [0,0,0,0,1,0,0,1,1,0,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,1,1,1,1,1,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,1,1,0,1,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,1,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,1,0,1,0,0,0,1,0,1,1,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,0,1,0,1,1,1,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,1,0,0,0,0,1,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,0,1,0,1,1,0,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,1,1,1,1,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,1,0,1,0,1,1,1,1,1,1,1,1,1,1,0,0,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,0,1,0,0,0,1,1,0,1,1,1,1,1,1],
    [0,0,0,0,0,0,1,1,0,1,1,1,0,1,0,1,1,1,1,1,1,1,1,1,1],
    [0,0,1,0,1,1,1,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,1,0,1,0,1,1,1,0,1,1,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,0,0,1,1,1,0,1,0,1,0,1,0,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,0,1,0,1,1,1,1,1,1,1,1,1,1,1,1],
], dtype=float)
XA = np.cumsum(YRAW, axis=1)                 # cumulative avoidances
XS = np.arange(1, 26)[None, :] - XA          # cumulative shocks
Y = 1.0 - YRAW[:, 1:25]                      # shock indicator, trials 2..25


def build():
    model = Model(
        y=Stochastic(2, lambda alpha, beta, xa, xs: Bernoulli(
            torch.exp(alpha * xa[:, :24] + beta * xs[:, :24])), monitor=False),
        alpha=Stochastic(lambda: Truncated(Flat(), -torch.inf, -1e-5)),
        A=Logical(lambda alpha: torch.exp(alpha)),
        beta=Stochastic(lambda: Truncated(Flat(), -torch.inf, -1e-5)),
        B=Logical(lambda beta: torch.exp(beta)),
    )
    model.set_samplers([Slice(["alpha", "beta"], 1.0)])
    inputs = {"xa": XA, "xs": XS}
    inits = [
        {"y": Y, "alpha": -1.0, "beta": -1.0},
        {"y": Y, "alpha": -2.0, "beta": -2.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/dogs.rst (Empirical Posterior Estimates)
    "alpha": {"Mean": -0.2442, "SD": 0.0241},
    "beta": {"Mean": -0.0789, "SD": 0.0118},
    "A": {"Mean": 0.7836},
    "B": {"Mean": 0.9242},
}
