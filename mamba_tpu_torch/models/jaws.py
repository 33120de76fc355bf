"""Jaws: repeated-measures growth with unstructured covariance (20 boys x 4).

Reference: doc/examples/jaws.jl (public OpenBUGS volume-2 dataset).  Golden
posterior (doc/examples/jaws.rst: 10000 it, burnin 2500, thin 2, 2 chains,
Slice+AMWG): beta1 1.8743, Sigma[1,1] 6.792, Sigma[4,4] 8.059.

The likelihood is the reference's ``BDiagNormal`` (block-diagonal MvNormal,
extensions.jl:18-33): 20 blocks sharing one 4x4 InverseWishart covariance,
one batched Cholesky and triangular solve here.  The AMWG block walks Sigma
in its Cholesky-link space (pdmatdistribution.jl:27-50).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import BDiagNormal, InverseWishart, Normal
from ..samplers import AMWG, Slice

Y = np.array([
    [47.8, 48.8, 49.0, 49.7], [46.4, 47.3, 47.7, 48.4],
    [46.3, 46.8, 47.8, 48.5], [45.1, 45.3, 46.1, 47.2],
    [47.6, 48.5, 48.9, 49.3], [52.5, 53.2, 53.3, 53.7],
    [51.2, 53.0, 54.3, 54.5], [49.8, 50.0, 50.3, 52.7],
    [48.1, 50.8, 52.3, 54.4], [45.0, 47.0, 47.3, 48.3],
    [51.2, 51.4, 51.6, 51.9], [48.5, 49.2, 53.0, 55.5],
    [52.1, 52.8, 53.7, 55.0], [48.2, 48.9, 49.3, 49.8],
    [49.6, 50.4, 51.2, 51.8], [50.7, 51.7, 52.7, 53.3],
    [47.2, 47.7, 48.4, 49.5], [53.3, 54.6, 55.1, 55.3],
    [46.2, 47.5, 48.1, 48.4], [46.3, 47.6, 51.3, 51.8],
])
AGE = np.array([8.0, 8.5, 9.0, 9.5])
N, M = Y.shape
YVEC = Y.reshape(-1)                       # vec(Y') row-major
X = np.tile(AGE, N)                        # kron(ones(N), age)


def build():
    model = Model(
        y=Stochastic(1, lambda beta0, beta1, x, Sigma: BDiagNormal(
            beta0 + beta1 * x, Sigma.expand(N, M, M)), monitor=False),
        beta0=Stochastic(lambda: Normal(0.0, math.sqrt(1000.0))),
        beta1=Stochastic(lambda: Normal(0.0, math.sqrt(1000.0))),
        Sigma=Stochastic(2, lambda: InverseWishart(4.0, torch.eye(M))),
    )
    model.set_samplers([
        Slice(["beta0", "beta1"], [10.0, 1.0]),
        AMWG("Sigma", 0.1),
    ])
    inputs = {"x": X}
    inits = [
        {"y": YVEC, "beta0": 40.0, "beta1": 1.0, "Sigma": np.eye(M)},
        {"y": YVEC, "beta0": 10.0, "beta1": 10.0, "Sigma": np.eye(M)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/jaws.rst (Empirical Posterior Estimates)
    "beta1": {"Mean": 1.8743, "SD": 0.2272},
    "Sigma[1,1]": {"Mean": 6.7916, "SD": 2.0232},
    "Sigma[4,4]": {"Mean": 8.0594, "SD": 2.4746},
}
