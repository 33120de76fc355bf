"""Epil: Poisson GLMM for epilepsy seizure counts (59 patients x 4 visits).

Reference: doc/examples/epil.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/epil.rst: 15000 it, burnin 2500, thin 2, 2 chains,
AMWG+Slice): alpha_Base 0.9110, alpha_Trt -0.7593, s2_b1 0.2491,
s2_b 0.1352.

The reference's 59x4 comprehension of per-cell ``Poisson(exp(...))``
objects (epil.jl:92-107) is one broadcast (59, 4) rate matrix and a single
batched Poisson likelihood here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, Normal, Poisson
from ..samplers import AMWG, NUTS, Slice

Y = np.array([
    [5, 3, 3, 3], [3, 5, 3, 3], [2, 4, 0, 5], [4, 4, 1, 4], [7, 18, 9, 21],
    [5, 2, 8, 7], [6, 4, 0, 2], [40, 20, 21, 12], [5, 6, 6, 5], [14, 13, 6, 0],
    [26, 12, 6, 22], [12, 6, 8, 4], [4, 4, 6, 2], [7, 9, 12, 14],
    [16, 24, 10, 9], [11, 0, 0, 5], [0, 0, 3, 3], [37, 29, 28, 29],
    [3, 5, 2, 5], [3, 0, 6, 7], [3, 4, 3, 4], [3, 4, 3, 4], [2, 3, 3, 5],
    [8, 12, 2, 8], [18, 24, 76, 25], [2, 1, 2, 1], [3, 1, 4, 2],
    [13, 15, 13, 12], [11, 14, 9, 8], [8, 7, 9, 4], [0, 4, 3, 0],
    [3, 6, 1, 3], [2, 6, 7, 4], [4, 3, 1, 3], [22, 17, 19, 16], [5, 4, 7, 4],
    [2, 4, 0, 4], [3, 7, 7, 7], [4, 18, 2, 5], [2, 1, 1, 0], [0, 2, 4, 0],
    [5, 4, 0, 3], [11, 14, 25, 15], [10, 5, 3, 8], [19, 7, 6, 7],
    [1, 1, 2, 3], [6, 10, 8, 8], [2, 1, 0, 0], [102, 65, 72, 63],
    [4, 3, 2, 4], [8, 6, 5, 7], [1, 3, 1, 5], [18, 11, 28, 13], [6, 3, 4, 0],
    [3, 5, 4, 3], [1, 23, 19, 8], [2, 3, 0, 1], [0, 0, 0, 0], [1, 4, 3, 2],
], dtype=float)
TRT = np.array([0] * 28 + [1] * 31, dtype=float)
BASE = np.array([11, 11, 6, 8, 66, 27, 12, 52, 23, 10, 52, 33, 18, 42, 87, 50,
                 18, 111, 18, 20, 12, 9, 17, 28, 55, 9, 10, 47, 76, 38, 19, 10,
                 19, 24, 31, 14, 11, 67, 41, 7, 22, 13, 46, 36, 38, 7, 36, 11,
                 151, 22, 41, 32, 56, 24, 16, 22, 25, 13, 12], dtype=float)
AGE = np.array([31, 30, 25, 36, 22, 29, 31, 42, 37, 28, 36, 24, 23, 36, 26, 26,
                28, 31, 32, 21, 29, 21, 32, 25, 30, 40, 19, 22, 18, 32, 20, 30,
                18, 24, 30, 35, 27, 20, 22, 28, 23, 40, 33, 21, 35, 25, 26, 25,
                22, 32, 25, 35, 21, 41, 32, 26, 21, 36, 37], dtype=float)
V4 = np.array([0, 0, 0, 1], dtype=float)
N, T = Y.shape

LOGBASE4 = np.log(BASE / 4.0)
BT = LOGBASE4 * TRT
LOGAGE = np.log(AGE)


def build(scheme: str = "reference"):
    lb4 = LOGBASE4 - LOGBASE4.mean()
    trt = TRT - TRT.mean()
    bt = BT - BT.mean()
    lage = LOGAGE - LOGAGE.mean()
    v4 = V4 - V4.mean()

    model = Model(
        y=Stochastic(2, lambda a0, alpha_Base, alpha_Trt, alpha_BT, alpha_Age,
                     alpha_V4, b1, b, lb4, trt, bt, lage, v4: Poisson(
                         torch.exp(a0 + alpha_Base * lb4[:, None]
                                 + alpha_Trt * trt[:, None]
                                 + alpha_BT * bt[:, None]
                                 + alpha_Age * lage[:, None]
                                 + alpha_V4 * v4[None, :]
                                 + b1[:, None] + b)), monitor=False),
        b1=Stochastic(1, lambda s2_b1: Normal(torch.zeros(N), torch.sqrt(s2_b1)),
                      monitor=False),
        b=Stochastic(2, lambda s2_b: Normal(torch.zeros((N, T)), torch.sqrt(s2_b)),
                     monitor=False),
        a0=Stochastic(lambda: Normal(0.0, 100.0), monitor=False),
        alpha_Base=Stochastic(lambda: Normal(0.0, 100.0)),
        alpha_Trt=Stochastic(lambda: Normal(0.0, 100.0)),
        alpha_BT=Stochastic(lambda: Normal(0.0, 100.0)),
        alpha_Age=Stochastic(lambda: Normal(0.0, 100.0)),
        alpha_V4=Stochastic(lambda: Normal(0.0, 100.0)),
        alpha0=Logical(lambda a0, alpha_Base, alpha_Trt, alpha_BT, alpha_Age,
                       alpha_V4: a0 - alpha_Base * LOGBASE4.mean()
                       - alpha_Trt * TRT.mean() - alpha_BT * BT.mean()
                       - alpha_Age * LOGAGE.mean() - alpha_V4 * V4.mean()),
        s2_b1=Stochastic(lambda: InverseGamma(0.001, 0.001)),
        s2_b=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    if scheme == "reference":
        model.set_samplers([
            AMWG(["a0", "alpha_Base", "alpha_Trt", "alpha_BT", "alpha_Age",
                  "alpha_V4"], 0.1),
            Slice("b1", 0.5),
            Slice("b", 0.5),
            Slice(["s2_b1", "s2_b"], 1.0, form="univariate"),
        ])
    elif scheme == "nuts":
        model.set_samplers([
            NUTS(["a0", "alpha_Base", "alpha_Trt", "alpha_BT", "alpha_Age",
                  "alpha_V4", "b1", "b"]),
            Slice(["s2_b1", "s2_b"], 1.0, form="univariate"),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    inputs = {"lb4": lb4, "trt": trt, "bt": bt, "lage": lage, "v4": v4}
    inits = [
        {"y": Y, "a0": 0.0, "alpha_Base": 0.0, "alpha_Trt": 0.0,
         "alpha_BT": 0.0, "alpha_Age": 0.0, "alpha_V4": 0.0, "s2_b1": 1.0,
         "s2_b": 1.0, "b1": np.zeros(N), "b": np.zeros((N, T))},
        {"y": Y, "a0": 1.0, "alpha_Base": 1.0, "alpha_Trt": 1.0,
         "alpha_BT": 1.0, "alpha_Age": 1.0, "alpha_V4": 1.0, "s2_b1": 10.0,
         "s2_b": 10.0, "b1": np.zeros(N), "b": np.zeros((N, T))},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/epil.rst (Empirical Posterior Estimates)
    "alpha_Base": {"Mean": 0.9110, "SD": 0.1354},
    "alpha_Trt": {"Mean": -0.7593, "SD": 0.3977},
    "s2_b1": {"Mean": 0.2491, "SD": 0.0732},
    "s2_b": {"Mean": 0.1352, "SD": 0.0318},
}
