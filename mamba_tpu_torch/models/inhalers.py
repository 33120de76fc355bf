"""Inhalers: ordered-categorical crossover trial (286 patients x 2 periods).

Reference: doc/examples/inhalers.jl (public OpenBUGS volume-1 dataset; run
config 5000 it, burnin 1000, thin 2, 2 chains, AMWG+Slice).  inhalers.rst
publishes no golden table; GOLDEN below is this model's converged posterior
(consistent with OpenBUGS's published beta ~= 1.1, kappa ~= 0.2).

Cutpoint ordering uses the reference's dependent improper truncations —
``a1 ~ Flat(-1000, a2)``, ``a2 ~ Flat(-1000, a3)`` (inhalers.jl:80-90) —
expressed as Truncated(Flat(), -1000, a2) nodes whose upper bound is
another node.  The 286x2 ordered-logit Categorical object array
(inhalers.jl:46-63) is one (286, 2, 4) padded-difference tensor, same
construction as bones.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import (Categorical, Flat, InverseGamma, Normal,
                                 Truncated)
from ..samplers import AMWG, Slice

PATTERN = np.array([[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [2, 3],
                    [2, 4], [3, 1], [3, 2], [3, 3], [3, 4], [4, 1], [4, 2],
                    [4, 3], [4, 4]])
NCUM = np.array([[59, 122], [157, 170], [173, 173], [175, 175], [186, 226],
                 [253, 268], [270, 270], [271, 271], [271, 278], [278, 280],
                 [280, 281], [281, 281], [282, 284], [285, 285], [285, 286],
                 [286, 286]])
TREAT = np.array([[1.0, -1.0], [-1.0, 1.0]])
PERIOD = np.array([[1.0, -1.0], [1.0, -1.0]])
CARRY = np.array([[0.0, -1.0], [0.0, 1.0]])
N, T, G = 286, 2, 2

# expand cumulative pattern counts to per-patient (group, response) rows
# (inhalers.jl:27-37)
GROUP = np.zeros(N, dtype=int)
RESPONSE = np.zeros((N, T))
_i = 0
for _k in range(16):
    for _g in range(G):
        while _i < NCUM[_k, _g]:
            GROUP[_i] = _g
            RESPONSE[_i] = PATTERN[_k]
            _i += 1


def build():
    model = Model(
        response=Stochastic(2, lambda a1, a2, a3, mu, b, group: _resp_dist(
            a1, a2, a3, mu, b, group), monitor=False),
        mu=Logical(2, lambda beta, pi_, kappa, treat, period, carry:
                   beta * treat / 2.0 + pi_ * period / 2.0 + kappa * carry,
                   monitor=False),
        b=Stochastic(1, lambda s2: Normal(torch.zeros(N), torch.sqrt(s2)),
                     monitor=False),
        a1=Stochastic(lambda a2: Truncated(Flat(), -1000.0, a2)),
        a2=Stochastic(lambda a3: Truncated(Flat(), -1000.0, a3)),
        a3=Stochastic(lambda: Truncated(Flat(), -1000.0, 1000.0)),
        beta=Stochastic(lambda: Normal(0.0, 1000.0)),
        pi_=Stochastic(lambda: Normal(0.0, 1000.0)),
        kappa=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([
        AMWG("b", 0.1),
        Slice(["a1", "a2", "a3"], 2.0),
        Slice(["beta", "pi_", "kappa", "s2"], 1.0, form="univariate"),
    ])
    inputs = {"group": GROUP, "treat": TREAT, "period": PERIOD,
              "carry": CARRY}
    inits = [
        {"response": RESPONSE, "beta": 0.0, "pi_": 0.0, "kappa": 0.0,
         "a1": 2.0, "a2": 3.0, "a3": 4.0, "s2": 1.0, "b": np.zeros(N)},
        {"response": RESPONSE, "beta": 1.0, "pi_": 1.0, "kappa": 0.0,
         "a1": 3.0, "a2": 4.0, "a3": 5.0, "s2": 10.0, "b": np.zeros(N)},
    ]
    return model, inputs, inits


def _resp_dist(a1, a2, a3, mu, b, group):
    a = torch.stack([a1, a2, a3])                       # (3,)
    eta = mu[group, :] + b[:, None]                   # (286, 2)
    q = torch.sigmoid(-(a[None, None, :] + eta[:, :, None]))  # (286,2,3)
    one = torch.ones_like(q[..., :1])
    zero = torch.zeros_like(one)
    q_full = torch.cat([one, q, zero], dim=-1)
    p = q_full[..., :-1] - q_full[..., 1:]            # (286, 2, 4)
    return Categorical(p)


GOLDEN = {  # converged posterior (no upstream table; OpenBUGS-consistent)
    "beta": {"Mean": 0.98},
    "kappa": {"Mean": 0.25},
    "pi_": {"Mean": -0.22},
    "s2": {"Mean": 1.05},
}
