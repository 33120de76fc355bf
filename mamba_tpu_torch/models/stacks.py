"""Stacks: robust (Laplace-errors) regression on the stack-loss data with
outlier detection.

Reference: doc/examples/stacks.jl (public OpenBUGS volume-1 data).  Golden
posterior (doc/examples/stacks.rst; 10000 it, burnin 2500, thin 2,
2 chains, NUTS+Slice): b[1] 0.8369, b0 -38.78, sigma 3.488,
outlier[21] ~0.60.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, Laplace, Normal
from ..samplers import NUTS, Slice

Y = np.array([42, 37, 37, 28, 18, 18, 19, 20, 15, 14, 14, 13, 11, 12, 8, 7,
              8, 8, 9, 15, 15], dtype=float)
X = np.array([
    [80, 27, 89], [80, 27, 88], [75, 25, 90], [62, 24, 87], [62, 22, 87],
    [62, 23, 87], [62, 24, 93], [62, 24, 93], [58, 23, 87], [58, 18, 80],
    [58, 18, 89], [58, 17, 88], [58, 18, 82], [58, 19, 93], [50, 18, 89],
    [50, 18, 86], [50, 19, 72], [50, 19, 79], [50, 20, 80], [56, 20, 82],
    [70, 20, 91]], dtype=float)
N, P = X.shape
MEANX = X.mean(0)
SDX = X.std(0, ddof=1)
Z = (X - MEANX) / SDX


def build():
    model = Model(
        y=Stochastic(1, lambda mu, s2: Laplace(mu, s2), monitor=False),
        beta0=Stochastic(lambda: Normal(0.0, 1000.0), monitor=False),
        beta=Stochastic(1, lambda: Normal(torch.zeros(P), 1000.0),
                        monitor=False),
        mu=Logical(1, lambda beta0, z, beta: beta0 + z @ beta, monitor=False),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001), monitor=False),
        sigma=Logical(lambda s2: math.sqrt(2.0) * s2),
        b0=Logical(lambda beta0, b, meanx: beta0 - torch.dot(b, meanx)),
        b=Logical(1, lambda beta, sdx: beta / sdx),
        outlier=Logical(1, lambda y, mu, sigma: (
            torch.abs((y - mu) / sigma) > 2.5).to(y.dtype),
            monitor=[1, 3, 4, 21]),
    )
    model.set_samplers([NUTS(["beta0", "beta"]), Slice("s2", 1.0)])
    inputs = {"z": Z, "meanx": MEANX, "sdx": SDX}
    inits = [
        {"y": Y, "beta0": 10.0, "beta": np.zeros(3), "s2": 10.0},
        {"y": Y, "beta0": 1.0, "beta": np.ones(3), "s2": 1.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/stacks.rst
    "b[1]": {"Mean": 0.8369},
    "b[2]": {"Mean": 0.7445},
    "b0": {"Mean": -38.777},
    "sigma": {"Mean": 3.488},
    "outlier[1]": {"Mean": 0.0427},
    "outlier[21]": {"Mean": 0.6000},
}
