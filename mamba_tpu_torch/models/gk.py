"""GK: likelihood-free inference for the g-and-k distribution by ABC.

Reference: doc/examples/gk.jl (contributed example; data simulated as in
Allingham et al. 2009).  The g-and-k distribution is defined only by its
quantile function, so the model is fit by approximate Bayesian computation
with order-statistic summaries: a user distribution with ``sample`` and
``quantile`` only (gk.jl:8-47), and the ABC sampler's decay and randeps
options (gk.jl:83-85).

Golden posterior (doc/examples/gk.rst, truth A=3, B=1, g=2, k=0.5):
A 3.0037, B 1.0576, g 2.0259, k 0.3511 (k is biased low at eps=0.1; that
bias is part of the published ABC target).
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model
from ..model.nodes import Stochastic
from ..ops.distributions import Uniform, UnivariateDistribution, distribution
from ..samplers import ABC


@distribution
class GK(UnivariateDistribution):
    """The quantile-defined g-and-k distribution (gk.jl:8-47): only
    ``sample`` and ``quantile``; it has no closed-form density, which is
    why the example uses ABC."""

    A: torch.Tensor = 0.0
    B: torch.Tensor = 1.0
    g: torch.Tensor = 0.0
    k: torch.Tensor = 0.0
    c: torch.Tensor = 0.8

    def _z2gk(self, z):
        term1 = torch.exp(-self.g * z)
        term2 = 1.0 + self.c * (1.0 - term1) / (1.0 + term1)
        term3 = (1.0 + z * z) ** self.k
        return self.A + self.B * z * term2 * term3

    def quantile(self, p):
        return self._z2gk(torch.special.ndtri(p))

    def sample(self, gen, shape=()):
        like = next(v for v in (self.A, self.B, self.g, self.k)
                    if isinstance(v, torch.Tensor))
        z = torch.randn(tuple(shape) + tuple(self.batch_shape), generator=gen,
                        dtype=like.dtype, device=gen.device)
        return self._z2gk(z)


NOBS = 1000
PROBS = (0.1, 0.25, 0.5, 0.75, 0.9)


def _simulate_data(seed: int = 123) -> np.ndarray:
    z = np.random.default_rng(seed).standard_normal(NOBS)
    term1 = np.exp(-2.0 * z)
    term2 = 1.0 + 0.8 * (1.0 - term1) / (1.0 + term1)
    term3 = (1.0 + z * z) ** 0.5
    return 3.0 + 1.0 * z * term2 * term3   # GK(3, 1, 2, 0.5)


def _stats(x):
    """The five order-statistic summaries (gk.jl:80): ``jnp.quantile``'s
    default linear interpolation, written with ``torch.sort`` so that it
    batches over chains (``torch.quantile`` has no batching rule)."""
    s = torch.sort(x).values
    pos = [(x.shape[-1] - 1) * p for p in PROBS]
    lo = [int(np.floor(q)) for q in pos]
    hi = [min(i + 1, x.shape[-1] - 1) for i in lo]
    frac = torch.tensor([q - i for q, i in zip(pos, lo)], dtype=x.dtype,
                        device=x.device)
    return s[lo] + frac * (s[hi] - s[lo])


def build():
    x = _simulate_data()
    model = Model(
        x=Stochastic(1, lambda A, B, g, k: GK(A, B, g, k), monitor=False),
        A=Stochastic(lambda: Uniform(0.0, 10.0)),
        B=Stochastic(lambda: Uniform(0.0, 10.0)),
        g=Stochastic(lambda: Uniform(0.0, 10.0)),
        k=Stochastic(lambda: Uniform(0.0, 10.0)),
    )
    model.set_samplers([
        ABC(["A", "B", "k"], 0.05, _stats, 0.1, maxdraw=50, decay=0.75,
            randeps=True),
        ABC("g", 0.5, _stats, 0.1, maxdraw=50, decay=0.75),
    ])
    med, sd = float(np.median(x)), float(np.std(x, ddof=1))
    iqr = float(np.quantile(x, 0.75) - np.quantile(x, 0.25))
    skew = float(np.mean((x - x.mean()) ** 3) / np.var(x, ddof=1) ** 1.5)
    inits = [
        {"x": x, "A": 3.5, "B": 0.5, "g": 2.0, "k": 0.5},
        {"x": x, "A": med, "B": sd, "g": 1.0, "k": 1.0},
        {"x": x, "A": med, "B": iqr, "g": skew, "k": 0.3},
    ]
    return model, {}, inits


GOLDEN = {  # doc/examples/gk.rst
    "A": {"Mean": 3.0037},
    "B": {"Mean": 1.0576},
    "g": {"Mean": 2.0259},
    "k": {"Mean": 0.3511},
}
