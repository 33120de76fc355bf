"""Leuk: Cox proportional-hazards via counting-process increments (BUGS Leuk).

Reference: doc/examples/leuk.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/leuk.rst: 10000 it, burnin 2500, thin 2, 2 chains,
AMWG+Slice): beta 1.5521, S_treat[1] 0.9830, S_treat[10] 0.7718.

The reference's per-cell ``Y[i,j] > 0 ? Poisson(...) : Flat()`` object
array (leuk.jl:37-44) uses Flat() as a "no contribution" placeholder for
cells outside the risk set; here the Poisson rate is masked to 0 there,
and Poisson(0).log_prob(0) == 0 reproduces Flat's zero log-density exactly
(dN is 0 off the risk set by construction).
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Gamma, Normal, Poisson
from ..samplers import AMWG, NUTS, Slice

T_OBS = np.array([1, 1, 2, 2, 3, 4, 4, 5, 5, 8, 8, 8, 8, 11, 11, 12, 12, 15,
                  17, 22, 23, 6, 6, 6, 6, 7, 9, 10, 10, 11, 13, 16, 17, 19,
                  20, 22, 23, 25, 32, 32, 34, 35])
FAIL = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                 1, 1, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0,
                 0, 0])
Z = np.array([0.5] * 21 + [-0.5] * 21)
TGRID = np.array([1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 16, 17, 22, 23,
                  35], dtype=float)
N = len(T_OBS)
T = len(TGRID) - 1
C = 0.001
R = 0.1

DN = (FAIL[:, None] * (T_OBS[:, None] == TGRID[None, :-1])).astype(float)
Y = (T_OBS[:, None] >= TGRID[None, :-1]).astype(float)
MU = C * R * np.diff(TGRID)


def build(scheme: str = "reference"):
    model = Model(
        dN=Stochastic(2, lambda beta, dL0, z, ymask: Poisson(
            ymask * torch.exp(beta * z)[:, None] * dL0[None, :]),
            monitor=False),
        dL0=Stochastic(1, lambda mu: Gamma(mu, 1.0 / C), monitor=False),
        beta=Stochastic(lambda: Normal(0.0, 1000.0)),
        S0=Logical(1, lambda dL0: torch.exp(-torch.cumsum(dL0, dim=0)), monitor=False),
        S_treat=Logical(1, lambda S0, beta: S0 ** torch.exp(-0.5 * beta)),
        S_placebo=Logical(1, lambda S0, beta: S0 ** torch.exp(0.5 * beta)),
    )
    if scheme == "reference":
        model.set_samplers([
            AMWG("dL0", 0.1),
            Slice("beta", 3.0),
        ])
    elif scheme == "nuts":
        model.set_samplers([NUTS(["dL0", "beta"])])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    inputs = {"z": Z, "ymask": Y, "mu": MU}
    inits = [
        {"dN": DN, "beta": 0.0, "dL0": np.ones(T)},
        {"dN": DN, "beta": 1.0, "dL0": np.full(T, 2.0)},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/leuk.rst (Empirical Posterior Estimates)
    "beta": {"Mean": 1.5521, "SD": 0.4250},
    "S_treat[1]": {"Mean": 0.9830},
    "S_treat[10]": {"Mean": 0.7718},
}
