"""Surgical: hierarchical binomial mortality rates in 12 hospitals.

Reference: doc/examples/surgical.jl (public OpenBUGS volume-1 data).
Golden posterior (doc/examples/surgical.rst; 10000 it, burnin 2500, thin 2,
2 chains, NUTS+Slice): mu -2.550, pop_mean 0.0731, s2 0.183, p[1] 0.0536.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Binomial, InverseGamma, Normal
from ..samplers import NUTS, Slice

R = np.array([0, 18, 8, 46, 8, 13, 9, 31, 14, 8, 29, 24], dtype=float)
NTRIALS = np.array([47, 148, 119, 810, 211, 196, 148, 215, 207, 97, 256,
                    360], dtype=float)
N = 12


def build():
    model = Model(
        r=Stochastic(1, lambda n, p: Binomial(n, p), monitor=False),
        p=Logical(1, lambda b: torch.sigmoid(b)),
        b=Stochastic(1, lambda mu, s2: Normal(mu.expand(N),
                                              torch.sqrt(s2)), monitor=False),
        mu=Stochastic(lambda: Normal(0.0, 1000.0)),
        pop_mean=Logical(lambda mu: torch.sigmoid(mu)),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([NUTS("b"), Slice(["mu", "s2"], 1.0)])
    inputs = {"n": NTRIALS}
    inits = [
        {"r": R, "b": np.full(N, 0.1), "s2": 1.0, "mu": 0.0},
        {"r": R, "b": np.full(N, 0.5), "s2": 10.0, "mu": 1.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/surgical.rst
    "mu": {"Mean": -2.550},
    "pop_mean": {"Mean": 0.0731},
    "s2": {"Mean": 0.183},
    "p[1]": {"Mean": 0.0536},
}
