"""Large hierarchical logistic GLMM — G groups x n observations, random
intercepts, shared fixed effects.

    y[g,i] ~ Bernoulli( sigmoid( x[g,i,:] @ beta + b[g] ) )
    b[g]   ~ Normal(0, sqrt(s2))
    beta   ~ Normal(0, sqrt(10))
    s2     ~ InverseGamma(2, 2)

At G=10,000 the NUTS block is ~10k-dimensional.  Synthetic data with known
truth from numpy's generator (the same draws as the JAX package's build for
the same ``seed``); ``build`` returns (model, inputs, inits, truth).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Logical, Stochastic
from ..ops.distributions import Bernoulli, InverseGamma, Normal
from ..samplers import NUTS, Gibbs

P = 4


def build(G: int = 10_000, n: int = 10, seed: int = 0,
          mass_window: int = 100, fused: bool = False,
          centered: bool = False):
    """``fused=True`` swaps the observation node's generic
    Bernoulli(sigmoid(einsum)) likelihood for the fused kernel
    (ops/fused_glmm.py): one pass computes the log-likelihood and both
    gradients for all chains.  Observations then live as an (n, G) matrix.

    ``centered=False`` (default) uses the non-centered parameterization:
    z ~ N(0,1), b = sqrt(s2)*z (Logical), with s2 inside the gradient
    block (log-transformed), which collapses the s2 <-> sum(b^2) funnel of
    the centered form.  ``centered=True`` keeps b stochastic with a
    conjugate InverseGamma Gibbs draw of s2 — the classical scheme."""
    rng = np.random.default_rng(seed)
    beta_true = np.array([1.0, -0.5, 0.25, 0.0])
    s2_true = 0.5
    b_true = rng.normal(0, np.sqrt(s2_true), G)
    X = rng.normal(0, 1, (G, n, P))
    logits = X @ beta_true + b_true[:, None]
    Y = (rng.random((G, n)) < 1 / (1 + np.exp(-logits))).astype(float)

    if fused:
        from ..ops.fused_glmm import BernoulliLogitGLMM
        y_node = Stochastic(2, lambda xt, beta, b: BernoulliLogitGLMM(
            xt, beta, b), monitor=False)
        inputs = {"xt": np.ascontiguousarray(X.transpose(2, 1, 0))}
        y_init = np.ascontiguousarray(Y.T)           # (n, G)
    else:
        y_node = Stochastic(2, lambda x, beta, b: Bernoulli(torch.sigmoid(
            torch.einsum("gnp,p->gn", x, beta) + b[:, None])), monitor=False)
        inputs = {"x": X}
        y_init = Y

    if centered:
        model = Model(
            y=y_node,
            b=Stochastic(1, lambda s2: Normal(torch.zeros(G), torch.sqrt(s2)),
                         monitor=False),
            beta=Stochastic(1, lambda: Normal(torch.zeros(P), math.sqrt(10.0))),
            s2=Stochastic(lambda: InverseGamma(2.0, 2.0)),
        )

        # Exact conjugate draw of the random-effect variance (the
        # reference's user-supplied Gibbs-block pattern,
        # doc/tutorial/line.jl:27-45): s2 | b ~ IG(2 + G/2, 2 + sum(b^2)/2),
        # for all chains at once from torch's gamma sampler.
        def s2_gibbs(gen, env):
            b = env["b"]                                  # (chains, G)
            shape = torch.full(b.shape[:1], 2.0 + 0.5 * b.shape[-1],
                               dtype=b.dtype, device=b.device)
            return {"s2": (2.0 + 0.5 * torch.sum(b * b, dim=-1))
                    / torch._standard_gamma(shape, generator=gen)}

        model.set_samplers([
            NUTS(["beta", "b"], mass_window=mass_window),
            Gibbs("s2", s2_gibbs),
        ])
        inits = [{"y": y_init, "beta": np.zeros(P), "b": np.zeros(G),
                  "s2": 1.0}]
    else:
        model = Model(
            y=y_node,
            b=Logical(1, lambda s2, z: torch.sqrt(s2) * z, monitor=False),
            z=Stochastic(1, lambda: Normal(torch.zeros(G), 1.0),
                         monitor=False),
            beta=Stochastic(1, lambda: Normal(torch.zeros(P), math.sqrt(10.0))),
            s2=Stochastic(lambda: InverseGamma(2.0, 2.0)),
        )
        model.set_samplers([
            NUTS(["beta", "z", "s2"], mass_window=mass_window),
        ])
        inits = [{"y": y_init, "beta": np.zeros(P), "z": np.zeros(G),
                  "s2": 1.0}]
    truth = {"beta": beta_true, "s2": s2_true, "b": b_true}
    return model, inputs, inits, truth
