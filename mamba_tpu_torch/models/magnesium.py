"""Magnesium: meta-analysis sensitivity study — six heterogeneity-prior
specifications fit jointly (6 prior rows x 8 trials).

Reference: doc/examples/magnesium.jl (public OpenBUGS volume-1 data).
Exercises the mixed ``Array{UnivariateDistribution}`` node capability: the
``priors`` vector has SIX different distribution families, expressed here
with ``Mixed`` (ops/distributions/mixed.py).  Golden posterior
(doc/examples/magnesium.rst; 12500 it, burnin 2500, thin 2, 2 chains):
tau[1] 0.551, OR[1] 0.478, tau[6] 0.568.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import (Binomial, InverseGamma, Normal, Truncated,
                                 Uniform)
from ..ops.distributions.mixed import Mixed
from ..samplers import AMWG, Slice

RT = np.array([1, 9, 2, 1, 10, 1, 1, 90], dtype=float)
NT = np.array([40, 135, 200, 48, 150, 59, 25, 1159], dtype=float)
RC = np.array([2, 23, 7, 1, 8, 9, 3, 118], dtype=float)
NC = np.array([36, 135, 200, 46, 148, 56, 23, 1157], dtype=float)
S2 = (1 / (RT + 0.5) + 1 / (NT - RT + 0.5)
      + 1 / (RC + 0.5) + 1 / (NC - RC + 0.5))
S2_0 = float(1 / np.mean(1 / S2))
RTX = np.tile(RT, (6, 1))
RCX = np.tile(RC, (6, 1))


def build():
    s2_0 = S2_0

    def tau_fn(priors):
        return torch.stack([
            torch.sqrt(priors[0]),
            torch.sqrt(priors[1]),
            priors[2],
            torch.sqrt(s2_0 * (1.0 / priors[3] - 1.0)),
            math.sqrt(s2_0) * (1.0 / priors[4] - 1.0),
            torch.sqrt(priors[5])])

    model = Model(
        rcx=Stochastic(2, lambda nc, pc: Binomial(nc[None, :], pc),
                       monitor=False),
        pc=Stochastic(2, lambda: Uniform(torch.zeros((6, 8)), 1.0),
                      monitor=False),
        rtx=Stochastic(2, lambda nt, pc, theta: Binomial(
            nt[None, :], torch.sigmoid(
                theta + torch.log(pc / (1.0 - pc)))), monitor=False),
        theta=Stochastic(2, lambda mu, tau: Normal(mu[:, None],
                                                   tau[:, None]),
                         monitor=False),
        mu=Stochastic(1, lambda: Uniform(torch.full((6,), -10.0), 10.0),
                      monitor=False),
        OR=Logical(1, lambda mu: torch.exp(mu)),
        tau=Logical(1, tau_fn),
        priors=Stochastic(1, lambda: Mixed(
            InverseGamma(0.001, 0.001),
            Uniform(0.0, 50.0),
            Uniform(0.0, 50.0),
            Uniform(0.0, 1.0),
            Uniform(0.0, 1.0),
            Truncated(Normal(0.0, float(np.sqrt(S2_0 / special.erf(0.75)))),
                      0.0, torch.inf)), monitor=False),
    )
    model.set_samplers([
        AMWG("theta", 0.1),
        AMWG("mu", 0.1),
        Slice("pc", 0.25, form="univariate"),
        Slice("priors", [1.0, 5.0, 5.0, 0.25, 0.25, 5.0],
              form="univariate"),
    ])
    inputs = {"nt": NT, "nc": NC}
    init = {"rcx": RCX, "rtx": RTX, "theta": np.zeros((6, 8)),
            "pc": np.full((6, 8), 0.5),
            "priors": np.array([1, 1, 1, 0.5, 0.5, 1.0])}
    inits = [dict(init, mu=np.full(6, -0.5)), dict(init, mu=np.full(6, 0.5))]
    return model, inputs, inits


GOLDEN = {  # doc/examples/magnesium.rst
    "tau[1]": {"Mean": 0.551},
    "tau[6]": {"Mean": 0.568},
    "OR[1]": {"Mean": 0.478},
    "OR[3]": {"Mean": 0.431},
}
