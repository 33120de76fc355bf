"""Discrete univariate distributions (batched torch).

Replaces the reference's Distributions.jl discrete imports (src/Mamba.jl).
This slice of the port carries ``Bernoulli``, the generic (``fused=False``)
GLMM likelihood.
"""

from __future__ import annotations

import torch

from .base import DiscreteUnivariateDistribution, distribution, _bc

__all__ = ["Bernoulli"]


@distribution
class Bernoulli(DiscreteUnivariateDistribution):
    p: torch.Tensor = 0.5

    def log_prob(self, x):
        (p,) = _bc(self.p, like=x)
        return torch.xlogy(x, p) + torch.special.xlog1py(1.0 - x, -p)

    def sample(self, gen, shape=()):
        (p,) = _bc(self.p)
        p = p.to(gen.device)
        u = torch.rand(tuple(shape) + p.shape, generator=gen, dtype=p.dtype,
                       device=gen.device)
        return (u < p).to(p.dtype)

    def in_support(self, x):
        return ((x == 0) | (x == 1)).expand(
            torch.broadcast_shapes(x.shape, self.batch_shape))

    def support_bounds(self):
        (p,) = _bc(self.p)
        return torch.zeros_like(p), torch.ones_like(p)

    def mean(self):
        return _bc(self.p)[0]
