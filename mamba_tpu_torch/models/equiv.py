"""Equiv: bioequivalence crossover trial (10 subjects x 2 periods).

Reference: doc/examples/equiv.jl (public OpenBUGS volume-1 dataset).  Golden
posterior (doc/examples/equiv.rst: 12500 it, burnin 2500, thin 2, 2 chains,
NUTS+Slice): mu 1.4387, phi -0.00356, theta 1.0003, equiv 0.9751.

The reference's 10x2 comprehension of ``Normal(m, sigma)`` objects
(equiv.jl:28-43) becomes one broadcast mean matrix ``mu + sgn_t*phi/2 +
sgn_p*pi/2 + delta`` with a single batched Normal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, Normal
from ..samplers import NUTS, Slice

Y = np.array([[1.40, 1.65], [1.64, 1.57], [1.44, 1.58], [1.36, 1.68],
              [1.65, 1.69], [1.08, 1.31], [1.09, 1.43], [1.25, 1.44],
              [1.25, 1.39], [1.30, 1.52]])
GROUP = np.array([1, 1, 2, 2, 2, 1, 1, 1, 2, 2])
# treatment indicator T[i,j] in {1,2}: period-1 treatment = group,
# period-2 treatment = 3 - group (equiv.jl:20)
TMAT = np.stack([GROUP, 3 - GROUP], axis=1)
SGN_T = (-1.0) ** (TMAT - 1)                     # (-1)^(T[i,j]-1)
SGN_P = (-1.0) ** np.array([0, 1])[None, :]      # (-1)^(j-1)
N, P = Y.shape


def build(scheme: str = "reference"):
    model = Model(
        y=Stochastic(2, lambda delta, mu, phi, pi_, s2_1, sgn_t, sgn_p: Normal(
            mu + sgn_t * phi / 2.0 + sgn_p * pi_ / 2.0 + delta,
            torch.sqrt(s2_1)), monitor=False),
        delta=Stochastic(2, lambda s2_2: Normal(torch.zeros((N, P)),
                                                torch.sqrt(s2_2)),
                         monitor=False),
        mu=Stochastic(lambda: Normal(0.0, 1000.0)),
        phi=Stochastic(lambda: Normal(0.0, 1000.0)),
        theta=Logical(lambda phi: torch.exp(phi)),
        pi_=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2_1=Stochastic(lambda: InverseGamma(0.001, 0.001)),
        s2_2=Stochastic(lambda: InverseGamma(0.001, 0.001)),
        equiv=Logical(lambda theta: (
            (theta > 0.8) & (theta < 1.2)).to(theta.dtype)),
    )
    if scheme == "reference":
        model.set_samplers([
            NUTS("delta"),
            Slice(["mu", "phi", "pi_"], 1.0),
            Slice(["s2_1", "s2_2"], 1.0, form="univariate"),
        ])
    elif scheme == "nuts":
        model.set_samplers([
            NUTS(["delta", "mu", "phi", "pi_"]),
            Slice(["s2_1", "s2_2"], 1.0, form="univariate"),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    inputs = {"sgn_t": SGN_T, "sgn_p": SGN_P}
    inits = [
        {"y": Y, "delta": np.zeros((N, P)), "mu": 0.0, "phi": 0.0,
         "pi_": 0.0, "s2_1": 1.0, "s2_2": 1.0},
        {"y": Y, "delta": np.zeros((N, P)), "mu": 10.0, "phi": 10.0,
         "pi_": 10.0, "s2_1": 10.0, "s2_2": 10.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/equiv.rst (Empirical Posterior Estimates)
    "mu": {"Mean": 1.4387, "SD": 0.0423},
    "phi": {"Mean": -0.00356, "SD": 0.0876},
    "theta": {"Mean": 1.0003, "SD": 0.0883},
    "equiv": {"Mean": 0.9751},
    "pi_": {"Mean": -0.1874, "SD": 0.0864},
}
