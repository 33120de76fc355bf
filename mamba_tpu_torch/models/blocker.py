"""Blocker: random-effects meta-analysis of 22 beta-blocker trials.

Reference: doc/examples/blocker.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/blocker.rst; 10000 it, burnin 2500, thin 2,
2 chains, AMWG+Slice): d -0.2556, delta_new -0.2501, s2 0.0182.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Binomial, InverseGamma, Normal
from ..samplers import AMWG, Slice

RT = np.array([3, 7, 5, 102, 28, 4, 98, 60, 25, 138, 64, 45, 9, 57, 25, 33,
               28, 8, 6, 32, 27, 22], dtype=float)
NT = np.array([38, 114, 69, 1533, 355, 59, 945, 632, 278, 1916, 873, 263,
               291, 858, 154, 207, 251, 151, 174, 209, 391, 680], dtype=float)
RC = np.array([3, 14, 11, 127, 27, 6, 152, 48, 37, 188, 52, 47, 16, 45, 31,
               38, 12, 6, 3, 40, 43, 39], dtype=float)
NC = np.array([39, 116, 93, 1520, 365, 52, 939, 471, 282, 1921, 583, 266,
               293, 883, 147, 213, 122, 154, 134, 218, 364, 674], dtype=float)
N = 22


def build():
    model = Model(
        rc=Stochastic(1, lambda mu, nc: Binomial(nc, torch.sigmoid(mu)),
                      monitor=False),
        rt=Stochastic(1, lambda mu, delta, nt: Binomial(
            nt, torch.sigmoid(mu + delta)), monitor=False),
        mu=Stochastic(1, lambda: Normal(torch.zeros(N), 1000.0), monitor=False),
        delta=Stochastic(1, lambda d, s2: Normal(d.expand(N),
                                                 torch.sqrt(s2)), monitor=False),
        delta_new=Stochastic(lambda d, s2: Normal(d, torch.sqrt(s2))),
        d=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([
        AMWG("mu", 0.1),
        AMWG(["delta", "delta_new"], 0.1),
        Slice(["d", "s2"], 1.0),
    ])
    inputs = {"nt": NT, "nc": NC}
    inits = [
        {"rc": RC, "rt": RT, "d": 0.0, "delta_new": 0.0, "s2": 1.0,
         "mu": np.zeros(N), "delta": np.zeros(N)},
        {"rc": RC, "rt": RT, "d": 2.0, "delta_new": 2.0, "s2": 10.0,
         "mu": np.full(N, 2.0), "delta": np.full(N, 2.0)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/blocker.rst
    "d": {"Mean": -0.2556},
    "delta_new": {"Mean": -0.2501},
    "s2": {"Mean": 0.0182},
}
