"""Asthma: Markov transition probabilities from treatment-state counts.

Reference: doc/examples/asthma.jl (public OpenBUGS dataset).  Golden
posterior (doc/examples/asthma.rst: 10000 it, burnin 2500, thin 2,
3 chains, SliceSimplex): q[1,1] 0.7616, q[2,2] 0.8544, q[3,1] 0.2937.

The reference holds a Multinomial and a Dirichlet per state row
(asthma.jl:18-35); here each is one batched distribution over the (3, 5)
node, and the SliceSimplex block updates each row simplex with its own
shrinking-simplex pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Dirichlet, Multinomial
from ..samplers import SliceSimplex

Y = np.array([
    [210, 60, 0, 1, 1],
    [88, 641, 0, 4, 13],
    [1, 0, 0, 0, 1],
], dtype=float)
M = np.array([272, 746, 2], dtype=float)
S, K = Y.shape


def build():
    model = Model(
        y=Stochastic(2, lambda m, q: Multinomial(m, q), monitor=False),
        q=Stochastic(2, lambda: Dirichlet(torch.ones(S, K))),
    )
    model.set_samplers([SliceSimplex("q")])
    rng = np.random.default_rng(123)
    inits = [
        {"y": Y, "q": rng.dirichlet(np.ones(K), size=S)}
        for _ in range(3)
    ]
    return model, {"m": M}, inits


GOLDEN = {  # doc/examples/asthma.rst (Empirical Posterior Estimates)
    "q[1,1]": {"Mean": 0.7616, "SD": 0.0272},
    "q[2,2]": {"Mean": 0.8544, "SD": 0.0131},
    "q[3,1]": {"Mean": 0.2937, "SD": 0.1741},
    "q[3,5]": {"Mean": 0.2827, "SD": 0.1709},
}
