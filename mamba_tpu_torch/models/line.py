"""Tutorial line model: Bayesian simple linear regression on 5 points.

Reference: doc/tutorial/line.jl.  Golden posterior (doc/tutorial.rst:432-442,
10000 iters, burnin 250, thin 2, 3 chains, NUTS+Slice):
beta[1] 0.5971 (SD 1.1489), beta[2] 0.8017 (SD 0.3483), s2 1.2204.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, Normal
from ..samplers import AMWG, NUTS, Slice


def build(chains: int = 3, seed: int = 42, scheme: str = "nuts"):
    """``scheme``: "nuts" (tutorial sampling scheme, doc/tutorial/line.jl)
    or "amwg_slice" (doc/examples/line_amwg_slice.jl: adaptive
    Metropolis-within-Gibbs on beta + slice on s2).  The inits are the JAX
    package's for the same ``seed``."""
    model = Model(
        y=Stochastic(1, lambda mu, s2: Normal(mu, torch.sqrt(s2)), monitor=False),
        mu=Logical(1, lambda xmat, beta: xmat @ beta, monitor=False),
        beta=Stochastic(1, lambda: Normal(torch.zeros(2), math.sqrt(1000.0))),
        s2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    if scheme == "amwg_slice":
        model.set_samplers([AMWG("beta", np.ones(2)), Slice("s2", 3.0)])
    else:
        model.set_samplers([NUTS("beta"), Slice("s2", 3.0)])

    x = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    y = np.array([1.0, 3.0, 3.0, 3.0, 5.0])
    inputs = {"xmat": np.stack([np.ones_like(x), x], axis=1)}
    rng = np.random.default_rng(seed)
    inits = [{"y": y, "beta": rng.normal(0.0, 1.0, 2), "s2": rng.gamma(1.0)}
             for _ in range(chains)]
    return model, inputs, inits


GOLDEN = {  # doc/tutorial.rst:432-442
    "beta[1]": {"Mean": 0.5971, "SD": 1.1489},
    "beta[2]": {"Mean": 0.8017, "SD": 0.3483},
    "s2": {"Mean": 1.2204, "SD": 1.1291},
}
