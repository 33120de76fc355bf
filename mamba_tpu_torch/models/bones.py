"""Bones: graded-response IRT for skeletal age (13 children x 34 indicators).

Reference: doc/examples/bones.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/bones.rst: 10000 it, burnin 2500, thin 2, 2 chains,
MISS+AMWG): theta[1] 0.3260, theta[5] 5.544, theta[13] 16.930.

The reference builds a ragged per-cell ``Categorical(p[1:ncat])`` object
array via a sequential-difference loop (bones.jl:57-76).  Here the ragged
categories are padded to K=5 with zero probability: Q[k] =
sigmoid(delta_j*(theta_i - gamma[j,k])) with NaN thresholds replaced by a
huge value so Q=0 beyond ncat_j, and p[k] = Q[k-1] - Q[k] with Q[0] = 1 —
one (13, 34, 5) tensor, one batched Categorical.  NaN grades are MISS-
imputed (the padded zero-probability tail is never drawn).
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Categorical, Normal
from ..samplers import AMWG, MISS

_G = np.nan
GAMMA = np.array([
    [0.7425, _G, _G, _G], [10.2670, _G, _G, _G], [10.5215, _G, _G, _G],
    [9.3877, _G, _G, _G], [0.2593, _G, _G, _G], [-0.5998, _G, _G, _G],
    [10.5891, _G, _G, _G], [6.6701, _G, _G, _G], [8.8921, _G, _G, _G],
    [12.4275, _G, _G, _G], [12.4788, _G, _G, _G], [13.7778, _G, _G, _G],
    [5.8374, _G, _G, _G], [6.9485, _G, _G, _G], [13.7184, _G, _G, _G],
    [14.3476, _G, _G, _G], [4.8066, _G, _G, _G], [9.1037, _G, _G, _G],
    [10.7483, _G, _G, _G], [0.3887, 1.0153, _G, _G], [3.2573, 7.0421, _G, _G],
    [11.6273, 14.4242, _G, _G], [15.8842, 17.4685, _G, _G],
    [14.8926, 16.7409, _G, _G], [15.5487, 16.8720, _G, _G],
    [15.4091, 17.0061, _G, _G], [3.9216, 5.2099, _G, _G],
    [15.4750, 16.9406, 17.4944, _G],
    [0.4927, 1.3556, 2.3016, 3.2535], [1.3059, 1.8793, 2.4970, 3.2306],
    [1.5012, 1.8902, 2.3689, 2.9495], [0.8021, 2.3873, 3.9525, 5.3198],
    [5.0022, 6.3704, 8.2832, 10.4988], [4.0168, 5.1537, 7.1053, 10.3038],
])
DELTA = np.array([2.9541, 0.6603, 0.7965, 1.0495, 5.7874, 3.8376, 0.6324,
                  0.8272, 0.6968, 0.8747, 0.8136, 0.8246, 0.6711, 0.978,
                  1.1528, 1.6923, 1.0331, 0.5381, 1.0688, 8.1123, 0.9974,
                  1.2656, 1.1802, 1.368, 1.5435, 1.5006, 1.6766, 1.4297,
                  3.385, 3.3085, 3.4007, 2.0906, 1.0954, 1.5329])
NCAT = np.array([2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                 3, 3, 3, 3, 3, 3, 3, 3, 4, 5, 5, 5, 5, 5, 5])
GRADE = np.array([
    [1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,2,1,1,1,1,1,1,1,1,2,1,1,2,1,1],
    [2,1,1,1,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,3,1,1,1,1,1,1,1,1,3,1,1,2,1,1],
    [2,1,1,1,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,3,1,1,1,1,1,1,1,1,4,3,3,3,1,1],
    [2,1,1,1,2,2,1,1,1,1,1,1,_G,1,1,1,1,1,1,3,1,1,1,1,1,1,1,1,4,5,4,3,1,1],
    [2,1,1,1,2,2,1,1,2,1,1,1,1,1,1,1,2,1,1,3,2,1,1,1,1,1,3,1,5,5,5,4,2,3],
    [2,1,1,1,2,2,1,2,1,1,1,1,1,2,1,1,2,_G,1,3,2,1,1,1,1,1,3,1,5,5,5,5,3,3],
    [2,1,1,1,2,2,1,1,1,_G,_G,1,1,1,1,1,2,_G,1,3,3,1,1,1,1,1,3,1,5,5,5,5,3,3],
    [2,1,2,2,2,2,2,2,1,_G,_G,1,2,2,1,1,2,2,1,3,2,1,1,1,1,1,3,1,5,5,5,5,3,4],
    [2,1,1,2,2,2,2,2,2,1,1,1,2,1,1,1,2,1,1,3,3,1,1,1,1,1,3,1,5,5,5,5,4,4],
    [2,1,2,2,2,2,2,2,2,1,1,1,2,2,2,1,2,_G,2,3,3,1,1,1,1,1,3,1,5,5,5,5,5,5],
    [2,1,_G,2,2,2,_G,2,2,1,_G,_G,2,2,_G,_G,2,1,2,3,3,_G,1,_G,1,1,3,1,5,5,5,5,5,5],
    [2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,1,_G,2,1,3,2,5,5,5,5,5,5],
    [2,2,2,2,2,2,2,2,2,2,_G,2,2,2,2,2,2,2,2,3,3,3,_G,2,_G,2,3,4,5,5,5,5,5,5],
])
NCHILD, NIND = GRADE.shape
# NaN thresholds -> +huge so sigmoid(delta*(theta - thr)) == 0 beyond ncat
GAMMA_PAD = np.where(np.isnan(GAMMA), 1e6, GAMMA)


def build():
    model = Model(
        grade=Stochastic(2, lambda theta, delta, gamma: _grade_dist(
            theta, delta, gamma), monitor=False),
        theta=Stochastic(1, lambda: Normal(torch.zeros(NCHILD), 100.0)),
    )
    model.set_samplers([
        MISS("grade"),
        AMWG("theta", 0.1),
    ])
    inputs = {"delta": DELTA, "gamma": GAMMA_PAD}
    inits = [
        {"grade": GRADE,
         "theta": np.array([0.5, 1, 2, 3, 5, 6, 7, 8, 9, 12, 13, 16, 18.0])},
        {"grade": GRADE,
         "theta": np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13.0])},
    ]
    return model, inputs, inits


def _grade_dist(theta, delta, gamma):
    # Q[i,j,k] = P(grade > k), k = 1..4; Q0 = 1; p[k] = Q[k-1] - Q[k]
    q = torch.sigmoid(delta[None, :, None]
                       * (theta[:, None, None] - gamma[None, :, :]))
    one = torch.ones_like(q[..., :1])
    zero = torch.zeros_like(one)
    q_full = torch.cat([one, q, zero], dim=-1)     # Q0..Q5
    p = q_full[..., :-1] - q_full[..., 1:]                # (13, 34, 5)
    return Categorical(p)


GOLDEN = {  # doc/examples/bones.rst (Empirical Posterior Estimates)
    "theta[1]": {"Mean": 0.3260, "SD": 0.2064},
    "theta[5]": {"Mean": 5.5443, "SD": 0.5024},
    "theta[13]": {"Mean": 16.9303, "SD": 0.7246},
}
