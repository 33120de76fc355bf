"""Birats: bivariate-normal random regression coefficients with an
InverseWishart covariance prior (30 rats x 5 weeks).

Reference: doc/examples/birats.jl (public OpenBUGS volume-2 data).  Golden
posterior (doc/examples/birats.rst; 10000 it, burnin 2500, thin 2,
2 chains): mu_beta [106.70, 6.180], sigmaC 6.143.

The reference's ``MultivariateDistribution[MvNormal(mu, Sigma) for i]``
node (birats.jl:57-63) is one batched MvNormal over the 30 rows; the
InverseWishart covariance is sampled through the CholeskyPD bijector, and
NUTS differentiates through the Cholesky factors and triangular solves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, InverseWishart, MvNormal, Normal
from ..samplers import NUTS, Slice
from .rats import Y as RATS_Y

Y = RATS_Y
X = np.array([8.0, 15.0, 22.0, 29.0, 36.0])
N, T = 30, 5
OMEGA = np.array([[200.0, 0.0], [0.0, 0.2]])


def build():
    model = Model(
        Y=Stochastic(2, lambda beta, x, sigmaC: Normal(
            beta[:, 0][:, None] + beta[:, 1][:, None] * x[None, :], sigmaC),
            monitor=False),
        beta=Stochastic(2, lambda mu_beta, Sigma: MvNormal(
            mu_beta.expand(N, 2), Sigma), monitor=False),
        mu_beta=Stochastic(1, lambda: MvNormal(torch.zeros(2),
                                               1.0e6 * torch.eye(2))),
        Sigma=Stochastic(2, lambda Omega: InverseWishart(2.0, Omega),
                         monitor=False),
        sigma2C=Stochastic(lambda: InverseGamma(0.001, 0.001),
                           monitor=False),
        sigmaC=Logical(lambda sigma2C: torch.sqrt(sigma2C)),
    )
    model.set_samplers([
        NUTS(["beta", "mu_beta", "Sigma"], mass_window=100),
        Slice("sigma2C", 10.0),
    ])
    inputs = {"x": X, "Omega": OMEGA}
    inits = [
        {"Y": Y, "beta": np.tile([100.0, 6.0], (N, 1)),
         "mu_beta": np.zeros(2), "Sigma": np.eye(2), "sigma2C": 1.0},
        {"Y": Y, "beta": np.tile([50.0, 3.0], (N, 1)),
         "mu_beta": np.array([10.0, 10.0]), "Sigma": 0.3 * np.eye(2),
         "sigma2C": 10.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/birats.rst
    "mu_beta[1]": {"Mean": 106.70},
    "mu_beta[2]": {"Mean": 6.180},
    "sigmaC": {"Mean": 6.143},
}
