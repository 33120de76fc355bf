"""Mice: Weibull regression for censored survival times (4 groups x 20 mice).

Reference: doc/examples/mice.jl (public OpenBUGS volume-1 dataset).  NaN
entries of ``t`` are right-censored at ``tcensor`` and imputed by the MISS
block from the truncated predictive (mice.jl:20-36, scheme mice.jl:76-79).

mice.rst publishes no golden table.  Semantics note: the reference scores
imputed entries with Distributions.jl's *normalized* truncated density
(logpdf(Truncated(...), x) includes -log sf(tcensor)); marginally that
differs from OpenBUGS's censoring construct (whose imputation contributes
the unnormalized density, recovering the sf(tcensor) censored likelihood).
We match the reference exactly; GOLDEN below is this semantics' converged
posterior (two independent schemes, PSRF ~= 1).

The reference's 4x20 ``Truncated(Weibull(r, exp(-beta[i]/r)), tcensor, Inf)``
object comprehension is one batched Truncated Weibull here (the lambda
positivity guard of mice.jl:26-29 is unnecessary since exp() > 0 always).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Exponential, Normal, Truncated, Weibull
from ..samplers import MISS, Slice

T = np.array([
    [12, 1, 21, 25, 11, 26, 27, 30, 13, 12, 21, 20, 23, 25, 23, 29, 35,
     np.nan, 31, 36],
    [32, 27, 23, 12, 18, np.nan, np.nan, 38, 29, 30, np.nan, 32, np.nan,
     np.nan, np.nan, np.nan, 25, 30, 37, 27],
    [22, 26, np.nan, 28, 19, 15, 12, 35, 35, 10, 22, 18, np.nan, 12, np.nan,
     np.nan, 31, 24, 37, 29],
    [27, 18, 22, 13, 18, 29, 28, np.nan, 16, 22, 26, 19, np.nan, np.nan, 17,
     28, 26, 12, 17, 26],
])
TCENSOR = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 40, 0, 0],
    [0, 0, 0, 0, 0, 40, 40, 0, 0, 0, 40, 0, 40, 40, 40, 40, 0, 0, 0, 0],
    [0, 0, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 24, 0, 40, 40, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 20, 0, 0, 0, 0, 29, 10, 0, 0, 0, 0, 0, 0],
], dtype=float)
M, N = T.shape


def build():
    model = Model(
        t=Stochastic(2, lambda r, beta, tcensor: Truncated(
            Weibull(r, torch.exp(-beta / r)[:, None].expand(M, N)),
            tcensor, torch.inf), monitor=False),
        r=Stochastic(lambda: Exponential(1000.0)),
        beta=Stochastic(1, lambda: Normal(torch.zeros(M), 10.0),
                        monitor=False),
        median=Logical(1, lambda beta, r: torch.exp(-beta / r)
                       * math.log(2.0) ** (1.0 / r)),
        veh_control=Logical(lambda beta: beta[1] - beta[0]),
        test_sub=Logical(lambda beta: beta[2] - beta[0]),
        pos_control=Logical(lambda beta: beta[3] - beta[0]),
    )
    model.set_samplers([
        MISS("t"),
        Slice("beta", 1.0, form="univariate"),
        Slice("r", 0.25),
    ])
    inputs = {"tcensor": TCENSOR}
    inits = [
        {"t": T, "beta": np.full(M, -1.0), "r": 1.0},
        {"t": T, "beta": np.full(M, -2.0), "r": 1.0},
    ]
    return model, inputs, inits


GOLDEN = {  # converged posterior under the reference's truncation semantics
    "r": {"Mean": 3.27},
    "median[1]": {"Mean": 22.8},
    "median[2]": {"Mean": 26.5},
    "veh_control": {"Mean": -0.49},
}
