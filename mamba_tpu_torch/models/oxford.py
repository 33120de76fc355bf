"""Oxford: childhood-cancer log-odds ratios over birth-year strata (K=120).

Reference: doc/examples/oxford.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/oxford.rst: 12500 it, burnin 2500, thin 2, 2 chains,
AMWG+Slice): alpha 0.5658, beta1 -0.0433, beta2 0.00548, s2 0.0262.

The reference's two per-stratum Binomial object arrays (oxford.jl:60-80)
become two batched Binomials over a length-120 probability vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Binomial, InverseGamma, Normal
from ..samplers import AMWG, NUTS, Slice

R1 = np.array([3, 5, 2, 7, 7, 2, 5, 3, 5, 11, 6, 6, 11, 4, 4, 2, 8, 8, 6, 5,
               15, 4, 9, 9, 4, 12, 8, 8, 6, 8, 12, 4, 7, 16, 12, 9, 4, 7, 8,
               11, 5, 12, 8, 17, 9, 3, 2, 7, 6, 5, 11, 14, 13, 8, 6, 4, 8, 4,
               8, 7, 15, 15, 9, 9, 5, 6, 3, 9, 12, 14, 16, 17, 8, 8, 9, 5, 9,
               11, 6, 14, 21, 16, 6, 9, 8, 9, 8, 4, 11, 11, 6, 9, 4, 4, 9, 9,
               10, 14, 6, 3, 4, 6, 10, 4, 3, 3, 10, 4, 10, 5, 4, 3, 13, 1, 7,
               5, 7, 6, 3, 7], dtype=float)
N1 = np.array([28, 21, 32, 35, 35, 38, 30, 43, 49, 53, 31, 35, 46, 53, 61, 40,
               29, 44, 52, 55, 61, 31, 48, 44, 42, 53, 56, 71, 43, 43, 43, 40,
               44, 70, 75, 71, 37, 31, 42, 46, 47, 55, 63, 91, 43, 39, 35, 32,
               53, 49, 75, 64, 69, 64, 49, 29, 40, 27, 48, 43, 61, 77, 55, 60,
               46, 28, 33, 32, 46, 57, 56, 78, 58, 52, 31, 28, 46, 42, 45, 63,
               71, 69, 43, 50, 31, 34, 54, 46, 58, 62, 52, 41, 34, 52, 63, 59,
               88, 62, 47, 53, 57, 74, 68, 61, 45, 45, 62, 73, 53, 39, 45, 51,
               55, 41, 53, 51, 42, 46, 54, 32], dtype=float)
R0 = np.array([0, 2, 2, 1, 2, 0, 1, 1, 1, 2, 4, 4, 2, 1, 7, 4, 3, 5, 3, 2, 4,
               1, 4, 5, 2, 7, 5, 8, 2, 3, 5, 4, 1, 6, 5, 11, 5, 2, 5, 8, 5, 6,
               6, 10, 7, 5, 5, 2, 8, 1, 13, 9, 11, 9, 4, 4, 8, 6, 8, 6, 8, 14,
               6, 5, 5, 2, 4, 2, 9, 5, 6, 7, 5, 10, 3, 2, 1, 7, 9, 13, 9, 11,
               4, 8, 2, 3, 7, 4, 7, 5, 6, 6, 5, 6, 9, 7, 7, 7, 4, 2, 3, 4, 10,
               3, 4, 2, 10, 5, 4, 5, 4, 6, 5, 3, 2, 2, 4, 6, 4, 1], dtype=float)
N0 = N1.copy()
YEAR = np.array([-10, -9, -9, -8, -8, -8, -7, -7, -7, -7, -6, -6, -6, -6, -6,
                 -5, -5, -5, -5, -5, -5, -4, -4, -4, -4, -4, -4, -4, -3, -3,
                 -3, -3, -3, -3, -3, -3, -2, -2, -2, -2, -2, -2, -2, -2, -2,
                 -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 0, 0, 0,
                 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
                 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5,
                 5, 5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 9, 9, 10],
                dtype=float)
K = len(R1)


def build(scheme: str = "reference"):
    model = Model(
        r0=Stochastic(1, lambda mu, n0: Binomial(n0, torch.sigmoid(mu)),
                      monitor=False),
        r1=Stochastic(1, lambda mu, alpha, beta1, beta2, year, b, n1: Binomial(
            n1, torch.sigmoid(mu + alpha + beta1 * year
                               + beta2 * (year ** 2 - 22.0) + b)),
            monitor=False),
        b=Stochastic(1, lambda s2: Normal(torch.zeros(K), torch.sqrt(s2)),
                     monitor=False),
        mu=Stochastic(1, lambda: Normal(torch.zeros(K), 1000.0), monitor=False),
        alpha=Stochastic(lambda: Normal(0.0, 1000.0)),
        beta1=Stochastic(lambda: Normal(0.0, 1000.0)),
        beta2=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    if scheme == "reference":
        model.set_samplers([
            AMWG(["alpha", "beta1", "beta2"], 1.0),
            Slice("s2", 1.0),
            Slice("mu", 1.0),
            Slice("b", 1.0),
        ])
    elif scheme == "nuts":
        model.set_samplers([
            NUTS(["alpha", "beta1", "beta2", "mu", "b"]),
            Slice("s2", 1.0, form="univariate"),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    inputs = {"n0": N0, "n1": N1, "year": YEAR}
    inits = [
        {"r0": R0, "r1": R1, "alpha": 0.0, "beta1": 0.0, "beta2": 0.0,
         "s2": 1.0, "b": np.zeros(K), "mu": np.zeros(K)},
        {"r0": R0, "r1": R1, "alpha": 1.0, "beta1": 1.0, "beta2": 1.0,
         "s2": 10.0, "b": np.zeros(K), "mu": np.zeros(K)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/oxford.rst (Empirical Posterior Estimates)
    "alpha": {"Mean": 0.5658, "SD": 0.0630},
    "beta1": {"Mean": -0.0433, "SD": 0.0162},
    "beta2": {"Mean": 0.00548, "SD": 0.00357},
    "s2": {"Mean": 0.0262, "SD": 0.0308},
}
