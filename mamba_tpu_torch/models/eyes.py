"""Eyes: 2-component normal mixture with latent discrete indicators.

Reference: doc/examples/eyes.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/eyes.rst:44-58; 10000 it, burnin 2500, thin 2,
2 chains): P[1] 0.6036, lambda[1] 536.753, lambda[2] 548.987, s2 ~15.8.

The reference builds one Normal and one Categorical object per observation
(eyes.jl:19-36); here one batched distribution covers all 48: the component
gather ``lam[T]`` is one indexing op, and the indicators are one DGS block
whose two candidates per element are scored for every chain at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import (Categorical, Dirichlet, InverseGamma, Normal,
                                 Uniform)
from ..samplers import DGS, Slice, SliceSimplex

Y = np.array([
    529.0, 530.0, 532.0, 533.1, 533.4, 533.6, 533.7, 534.1, 534.8, 535.3,
    535.4, 535.9, 536.1, 536.3, 536.4, 536.6, 537.0, 537.4, 537.5, 538.3,
    538.5, 538.6, 539.4, 539.6, 540.4, 540.8, 542.0, 542.8, 543.0, 543.5,
    543.8, 543.9, 545.3, 546.2, 548.8, 548.7, 548.9, 549.0, 549.4, 549.9,
    550.6, 551.2, 551.4, 551.5, 551.6, 552.8, 552.9, 553.2])
N = 48


def build():
    model = Model(
        y=Stochastic(1, lambda lam, T, s2: Normal(
            lam[T.long() - 1], torch.sqrt(s2)), monitor=False),
        T=Stochastic(1, lambda P: Categorical(P.expand(N, 2)), monitor=False),
        P=Stochastic(1, lambda alpha: Dirichlet(alpha)),
        lam=Logical(1, lambda lambda0, theta: torch.stack(
            [lambda0, lambda0 + theta])),
        lambda0=Stochastic(lambda: Normal(0.0, 1000.0), monitor=False),
        theta=Stochastic(lambda: Uniform(0.0, 1000.0), monitor=False),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([
        DGS("T"),
        Slice(["lambda0", "theta"], [5.0, 1.0]),
        Slice("s2", 2.0, transform=True),
        SliceSimplex("P", scale=0.75),
    ])
    inputs = {"alpha": np.array([1.0, 1.0])}
    inits = [
        {"y": Y, "T": np.ones(N), "P": [0.5, 0.5], "lambda0": 535.0,
         "theta": 5.0, "s2": 10.0},
        {"y": Y, "T": np.ones(N), "P": [0.5, 0.5], "lambda0": 550.0,
         "theta": 1.0, "s2": 1.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/eyes.rst:44-58
    "P[1]": {"Mean": 0.6036},
    "lam[1]": {"Mean": 536.753},
    "lam[2]": {"Mean": 548.987},
}
