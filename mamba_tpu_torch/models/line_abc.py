"""Line regression fit by approximate Bayesian computation.

Reference: doc/examples/line_abc.jl: the tutorial's 5-point straight-line
data fit again without a likelihood: a Normal-kernel ABC block on ``beta``
with the identity summary and an Epanechnikov-kernel block on ``s2`` with
(mean, sd) summaries, both with ``nsim=3`` replicate simulations and a
``maxdraw=100`` retry loop (line_abc.jl:36-48).

Golden posterior (doc/examples/line_abc.rst): beta[1] 0.7235,
beta[2] 0.7747, s2 1.3074 (heavy-tailed; SD ~2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import InverseGamma, MvNormal
from ..samplers import ABC

X = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
Y = np.array([1.0, 3.0, 3.0, 3.0, 5.0])
XMAT = np.stack([np.ones(5), X], axis=1)


def _mean_sd(x):
    return torch.stack([torch.mean(x), torch.std(x, correction=1)])


def build():
    model = Model(
        y=Stochastic(1, lambda xmat, beta, s2: MvNormal(
            xmat @ beta, torch.sqrt(s2)), monitor=False),
        beta=Stochastic(1, lambda: MvNormal(torch.zeros(2), math.sqrt(100.0))),
        s2=Stochastic(lambda: InverseGamma(0.01, 0.01)),
    )
    model.set_samplers([
        ABC("beta", np.array([0.5, 0.25]), lambda x: x, 0.5,
            kernel="normal", maxdraw=100, nsim=3),
        ABC("s2", 0.5, _mean_sd, 0.1, kernel="epanechnikov", maxdraw=100,
            nsim=3),
    ])
    rng = np.random.default_rng(123)
    inits = [{"y": Y, "beta": rng.standard_normal(2),
              "s2": rng.gamma(1.0, 1.0)} for _ in range(3)]
    return model, {"xmat": XMAT}, inits


GOLDEN = {  # doc/examples/line_abc.rst
    "beta[1]": {"Mean": 0.7235},
    "beta[2]": {"Mean": 0.7747},
    "s2": {"Mean": 1.3074},
}
