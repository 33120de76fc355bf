"""Kidney: Weibull frailty model for recurrent infection times.

Reference: doc/examples/kidney.jl (public OpenBUGS volume-1 dataset).
38 patients x 2 recurrence times; NaN entries of ``t`` are right-censored
at ``tcensor`` and imputed by the MISS block from the truncated predictive
(kidney.jl:41-63, scheme kidney.jl:106-111).  Patient-level log-frailties
``b[i] ~ Normal(0, sqrt(s2))`` enter the Weibull scale through
``lambda = exp(-mu / r)``.

kidney.rst publishes no golden table (results section empty); the test
asserts sign/stability features of the converged posterior instead.

The reference's 38x2 ``UnivariateDistribution`` comprehension
(kidney.jl:44-62) is one batched Truncated Weibull here.  Its
``0 < lambda < Inf`` overflow guard is replaced by clipping the log-scale
exponent, which is exact on the sampled region and keeps the density
finite under float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Gamma, InverseGamma, Normal, Truncated, Weibull
from ..samplers import MISS, Slice

nan = np.nan
T = np.array(
    [8, 16, 23, nan, 22, 28, 447, 318, 30, 12, 24, 245, 7, 9, 511, 30, 53,
     196, 15, 154, 7, 333, 141, nan, 96, 38, nan, nan, 536, nan, 17, nan,
     185, 177, 292, 114, nan, nan, 15, nan, 152, 562, 402, nan, 13, 66, 39,
     nan, 12, 40, nan, 201, 132, 156, 34, 30, 2, 25, 130, 26, 27, 58, nan,
     43, 152, 30, 190, nan, 119, 8, nan, nan, nan, 78, 63, nan],
).reshape(38, 2)
TCENSOR = np.array(
    [0, 0, 0, 13, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     8, 0, 0, 149, 70, 0, 25, 0, 4, 0, 0, 0, 0, 22, 159, 0, 108, 0, 0, 0,
     24, 0, 0, 0, 46, 0, 0, 113, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0,
     0, 0, 5, 0, 0, 54, 16, 6, 0, 0, 8],
    dtype=float,
).reshape(38, 2)
AGE = np.array(
    [28, 28, 48, 48, 32, 32, 31, 32, 10, 10, 16, 17, 51, 51, 55, 56, 69, 69,
     51, 52, 44, 44, 34, 34, 35, 35, 42, 42, 17, 17, 60, 60, 60, 60, 43, 44,
     53, 53, 44, 44, 46, 47, 30, 30, 62, 63, 42, 43, 43, 43, 57, 58, 10, 10,
     52, 52, 53, 53, 54, 54, 56, 56, 50, 51, 57, 57, 44, 45, 22, 22, 42, 42,
     52, 52, 60, 60],
    dtype=float,
).reshape(38, 2)
SEX = np.array([0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1,
                0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0],
               dtype=float)
DISEASE = np.array([1, 2, 1, 1, 1, 1, 2, 2, 3, 2, 3, 1, 3, 3, 1, 3, 1, 1, 2,
                    1, 4, 1, 3, 3, 3, 3, 2, 3, 2, 2, 3, 3, 4, 2, 1, 1, 4, 4])
N, M = T.shape
DX = (DISEASE[:, None] == np.arange(2, 5)[None, :]).astype(float)  # (38, 3)


def build():
    model = Model(
        t=Stochastic(2, lambda r, mu, tcensor: Truncated(
            Weibull(r, torch.exp(torch.clamp(-mu / r, -60.0, 60.0))),
            tcensor, torch.inf), monitor=False),
        mu=Logical(2, lambda alpha, beta_age, age, beta_sex, sex, Dx, beta_Dx,
                   b: (alpha + beta_age * age + (beta_sex * sex
                       + Dx @ beta_Dx + b)[:, None]), monitor=False),
        b=Stochastic(1, lambda s2: Normal(torch.zeros(N), torch.sqrt(s2)),
                     monitor=False),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
        alpha=Stochastic(lambda: Normal(0.0, 100.0)),
        beta_age=Stochastic(lambda: Normal(0.0, 100.0)),
        beta_sex=Stochastic(lambda: Normal(0.0, 100.0)),
        beta_Dx=Stochastic(1, lambda: Normal(torch.zeros(3), 100.0)),
        r=Stochastic(lambda: Gamma(1.0, 1000.0)),
    )
    model.set_samplers([
        MISS("t"),
        Slice(["alpha", "beta_age", "beta_sex", "beta_Dx"], 0.1),
        Slice("b", 0.01),
        Slice("s2", 0.1),
        Slice("r", 0.001),
    ])
    inputs = {"tcensor": TCENSOR, "age": AGE, "sex": SEX, "Dx": DX}
    # Over-dispersed but PHYSICAL inits: beta_age multiplies ages of
    # 10-70, so |beta_age| ~ 1 puts mu ~ -50 and the Weibull scale at
    # exp(-mu/r) ~ e+33 — the MISS block then imputes censored times of
    # ~4e16, a regime where the t-likelihood is so steep (|dlogf| ~ 1e4
    # per 0.1 of a coefficient) that slice shrinkage degenerates (the
    # reference's own kidney.jl inits keep coefficients modest).
    inits = [
        {"t": T, "alpha": 0.0, "beta_age": 0.0, "beta_sex": 0.0,
         "beta_Dx": np.zeros(3), "s2": 3.0, "r": 1.0, "b": np.zeros(N)},
        {"t": T, "alpha": 1.0, "beta_age": -0.02, "beta_sex": 0.5,
         "beta_Dx": 0.5 * np.ones(3), "s2": 1.0, "r": 1.5,
         "b": np.zeros(N)},
    ]
    return model, inputs, inits
