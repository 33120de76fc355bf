"""Continuous univariate distributions (batched torch).

Replaces the reference's use of Distributions.jl univariates (imported in
src/Mamba.jl:8-44).  Every log_prob is one elementwise expression over
arbitrarily batched parameters.  This slice of the port carries the two the
GLMM needs; the rest follow with the model zoo.
"""

from __future__ import annotations

import torch

from .. import bijectors as bij
from .base import UnivariateDistribution, distribution, _bc

__all__ = ["Normal", "InverseGamma"]

_HALF_LOG_2PI = 0.9189385332046727


@distribution
class Normal(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        z = (x - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI

    def sample(self, gen, shape=()):
        mu, sigma = (t.to(gen.device) for t in _bc(self.mu, self.sigma))
        z = torch.randn(tuple(shape) + mu.shape, generator=gen,
                        dtype=mu.dtype, device=gen.device)
        return mu + sigma * z

    def cdf(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        return torch.special.ndtr((x - mu) / sigma)

    def icdf(self, q):
        mu, sigma = _bc(self.mu, self.sigma, like=q)
        return mu + sigma * torch.special.ndtri(q)

    def mean(self):
        return _bc(self.mu, self.sigma)[0]

    def variance(self):
        s = _bc(self.mu, self.sigma)[1]
        return s * s


@distribution
class InverseGamma(UnivariateDistribution):
    """shape alpha, scale beta: pdf ∝ x^-(a+1) exp(-b/x).
    Accessors ``shape``/``scale`` mirror the reference's user-Gibbs usage
    (doc/tutorial/line.jl:41-42)."""
    alpha: torch.Tensor = 1.0
    beta: torch.Tensor = 1.0

    @property
    def shape_param(self):
        return self.alpha

    @property
    def scale_param(self):
        return self.beta

    def log_prob(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - b / x

    def sample(self, gen, shape=()):
        a, b = _bc(self.alpha, self.beta)
        a = a.to(gen.device).expand(tuple(shape) + a.shape)
        return b.to(gen.device) / torch._standard_gamma(a, generator=gen)

    def in_support(self, x):
        return (x > 0).expand(torch.broadcast_shapes(x.shape, self.batch_shape))

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return torch.special.gammaincc(a, b / x)

    def mean(self):
        a, b = _bc(self.alpha, self.beta)
        return b / (a - 1.0)
