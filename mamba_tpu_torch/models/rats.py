"""Rats: BUGS hierarchical random-effects growth curves (30 rats x 5 weeks).

Reference: doc/examples/rats.jl (data + model spec; public OpenBUGS volume-1
dataset).  Golden posterior (doc/examples/rats.rst:42-47, upstream 10000
iterations, burnin 2500, thin 2, 2 chains): s2_c 37.254 (SD 6.03),
mu_beta 6.1831, alpha0 106.626.  The same data, schemes and inits as the JAX
package's ``models/rats.py``.

The per-rat likelihood loops of the reference are one batched (30, 5)
likelihood: ``alpha[rat] + beta[rat] * Xm`` is broadcasting, not gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import InverseGamma, Normal
from ..samplers import AMWG, NUTS, Gibbs, Slice

# OpenBUGS rats weight data: row = rat, column = week (rats.jl:4-36)
Y = np.array([
    [151, 199, 246, 283, 320], [145, 199, 249, 293, 354],
    [147, 214, 263, 312, 328], [155, 200, 237, 272, 297],
    [135, 188, 230, 280, 323], [159, 210, 252, 298, 331],
    [141, 189, 231, 275, 305], [159, 201, 248, 297, 338],
    [177, 236, 285, 350, 376], [134, 182, 220, 260, 296],
    [160, 208, 261, 313, 352], [143, 188, 220, 273, 314],
    [154, 200, 244, 289, 325], [171, 221, 270, 326, 358],
    [163, 216, 242, 281, 312], [160, 207, 248, 288, 324],
    [142, 187, 234, 280, 316], [156, 203, 243, 283, 317],
    [157, 212, 259, 307, 336], [152, 203, 246, 286, 321],
    [154, 205, 253, 298, 334], [139, 190, 225, 267, 302],
    [146, 191, 229, 272, 302], [157, 211, 250, 285, 323],
    [132, 185, 237, 286, 331], [160, 207, 257, 303, 345],
    [169, 216, 261, 295, 333], [157, 205, 248, 289, 316],
    [137, 180, 219, 258, 291], [153, 200, 244, 286, 324],
], dtype=float)
X = np.array([8.0, 15.0, 22.0, 29.0, 36.0])
XBAR = float(X.mean())


def _inverse_gamma(gen, shape: float, scale):
    """InverseGamma(shape, scale) draws, one per element of ``scale``, from
    torch's gamma sampler with the run's generator."""
    return scale / torch._standard_gamma(torch.full_like(scale, shape),
                                         generator=gen)


def var_gibbs(gen, env):
    """Exact conjugate draws of the three variances for every chain,
    s2 | rest ~ InverseGamma(a + n/2, b + SS/2) (the user-supplied
    Gibbs-block pattern of reference doc/tutorial/line.jl:27-45).  ``env``
    holds chain-stacked values: y (C, 30, 5), alpha and beta (C, 30),
    mu_alpha and mu_beta (C,).  Draws s2_c, s2_alpha, s2_beta in that
    order."""
    y, alpha, beta = env["y"], env["alpha"], env["beta"]
    fit = alpha[:, :, None] + beta[:, :, None] * env["Xm"]
    sse = torch.sum((y - fit) ** 2, dim=(1, 2))
    ss_alpha = torch.sum((alpha - env["mu_alpha"][:, None]) ** 2, dim=1)
    ss_beta = torch.sum((beta - env["mu_beta"][:, None]) ** 2, dim=1)
    return {
        "s2_c": _inverse_gamma(gen, 0.001 + 75.0, 0.001 + 0.5 * sse),
        "s2_alpha": _inverse_gamma(gen, 0.001 + 15.0, 0.001 + 0.5 * ss_alpha),
        "s2_beta": _inverse_gamma(gen, 0.001 + 15.0, 0.001 + 0.5 * ss_beta),
    }


def build(scheme: str = "reference"):
    """``scheme='reference'`` — the Slice+AMWG blocks of rats.jl:112-117;
    ``scheme='nuts'`` — NUTS over the 62 continuous effects plus exact
    conjugate Normal/InverseGamma Gibbs draws of the three variances;
    ``scheme='nuts-slice'`` — the same NUTS block with a log-space slice
    sweep on the variances instead (the generic form where no conjugate
    draw exists)."""
    model = Model(
        y=Stochastic(2, lambda alpha, beta, Xm, s2_c: Normal(
            alpha[:, None] + beta[:, None] * Xm[None, :], torch.sqrt(s2_c)),
            monitor=False),
        alpha=Stochastic(1, lambda mu_alpha, s2_alpha: Normal(
            mu_alpha.expand(30), torch.sqrt(s2_alpha)), monitor=False),
        alpha0=Logical(lambda mu_alpha, xbar, mu_beta: mu_alpha - xbar * mu_beta),
        mu_alpha=Stochastic(lambda: Normal(0.0, 1000.0), monitor=False),
        s2_alpha=Stochastic(lambda: InverseGamma(0.001, 0.001), monitor=False),
        beta=Stochastic(1, lambda mu_beta, s2_beta: Normal(
            mu_beta.expand(30), torch.sqrt(s2_beta)), monitor=False),
        mu_beta=Stochastic(lambda: Normal(0.0, 1000.0)),
        s2_beta=Stochastic(lambda: InverseGamma(0.001, 0.001), monitor=False),
        s2_c=Stochastic(lambda: InverseGamma(0.001, 0.001)),
    )
    if scheme == "reference":
        model.set_samplers([
            Slice("s2_c", 10.0),
            AMWG("alpha", 100.0),
            Slice(["mu_alpha", "s2_alpha"], [100.0, 10.0], form="univariate"),
            AMWG("beta", 1.0),
            Slice(["mu_beta", "s2_beta"], 1.0, form="univariate"),
        ])
    elif scheme == "nuts":
        # mass_window=100 with expanding windows refreshes at 100 and 300;
        # pair with warmup >= 500, so the last refresh leaves a
        # step-size-only re-adaptation tail and chains from the
        # over-dispersed second init (rats.jl:101-108) have converged
        # before the final window opens
        model.set_samplers([
            NUTS(["alpha", "beta", "mu_alpha", "mu_beta"], mass_window=100),
            Gibbs(["s2_c", "s2_alpha", "s2_beta"], var_gibbs),
        ])
    elif scheme == "nuts-slice":
        # log-space slice: the three variances live on scales 0.27 / 37 /
        # 220 and Mamba-style slice brackets never step out, so a linear
        # width under-covers one of them; 2.5 nats is scale-free
        model.set_samplers([
            NUTS(["alpha", "beta", "mu_alpha", "mu_beta"], mass_window=100),
            Slice(["s2_c", "s2_alpha", "s2_beta"], 2.5, form="univariate",
                  transform=True),
        ])
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    inputs = {"Xm": X - XBAR, "xbar": XBAR}
    inits = [
        {"y": Y, "alpha": np.full(30, 250.0), "beta": np.full(30, 6.0),
         "mu_alpha": 150.0, "mu_beta": 10.0, "s2_c": 1.0, "s2_alpha": 1.0,
         "s2_beta": 1.0},
        {"y": Y, "alpha": np.full(30, 20.0), "beta": np.full(30, 0.6),
         "mu_alpha": 15.0, "mu_beta": 1.0, "s2_c": 10.0, "s2_alpha": 10.0,
         "s2_beta": 10.0},
    ]
    return model, inputs, inits


GOLDEN = {  # doc/examples/rats.rst:42-47 (upstream 10000/2500/2, 2 chains)
    "s2_c": {"Mean": 37.254, "SD": 6.027},
    "alpha0": {"Mean": 106.626, "SD": 3.652},
    "mu_beta": {"Mean": 6.1831, "SD": 0.1062},
}
