"""Dyes: variance-components model (6 batches x 5 samples).

Reference: doc/examples/dyes.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/dyes.rst; 10000 it, burnin 2500, thin 2, 2 chains,
NUTS+Slice): theta 1526.7, s2_within 2887.6, mu[1] 1511.5.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import InverseGamma, Normal
from ..samplers import NUTS, Slice

Y = np.array([
    [1545, 1440, 1440, 1520, 1580],
    [1540, 1555, 1490, 1560, 1495],
    [1595, 1550, 1605, 1510, 1560],
    [1445, 1440, 1595, 1465, 1545],
    [1595, 1630, 1515, 1635, 1625],
    [1520, 1455, 1450, 1480, 1445]], dtype=float)
BATCHES, SAMPLES = 6, 5


def build():
    model = Model(
        y=Stochastic(2, lambda mu, s2_within: Normal(
            mu[:, None], torch.sqrt(s2_within)), monitor=False),
        mu=Stochastic(1, lambda theta, s2_between: Normal(
            theta.expand(BATCHES), torch.sqrt(s2_between))),
        theta=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2_within=Stochastic(lambda: InverseGamma(0.001, 0.001)),
        s2_between=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([
        NUTS(["mu", "theta"]),
        Slice(["s2_within", "s2_between"], 1000.0),
    ])
    inits = [
        {"y": Y, "theta": 1500.0, "s2_within": 1.0, "s2_between": 1.0,
         "mu": np.full(BATCHES, 1500.0)},
        {"y": Y, "theta": 3000.0, "s2_within": 10.0, "s2_between": 10.0,
         "mu": np.full(BATCHES, 3000.0)},
    ]
    return model, {}, inits


GOLDEN = {  # doc/examples/dyes.rst
    "theta": {"Mean": 1526.72},
    "s2_within": {"Mean": 2887.6},
    "mu[1]": {"Mean": 1511.48},
    "mu[3]": {"Mean": 1552.67},
}
