"""Discrete univariate distributions (batched torch).

Replaces the reference's Distributions.jl discrete imports (src/Mamba.jl) used
by the DGS/MISS samplers and the mixture/binary example models.  Each
distribution exposes ``support_bounds`` so a Gibbs sampler over a discrete
node can enumerate a padded support (the reference enumerates dynamically,
src/samplers/dgs.jl:109-126).

Values are whole numbers held in the float state, so every ``in_support``
tests ``_is_int`` on a float tensor.
"""

from __future__ import annotations

import torch

from .base import (DiscreteUnivariateDistribution, distribution, _bc, _is_int,
                   _on, _rand, _rbinomial, _rcategorical, _rgamma,
                   _rpoisson, _support)
from .. import random as R

__all__ = [
    "Bernoulli", "Binomial", "Poisson", "Geometric", "NegativeBinomial",
    "Categorical", "DiscreteUniform", "Hypergeometric",
]


@distribution
class Bernoulli(DiscreteUnivariateDistribution):
    p: torch.Tensor = 0.5

    def log_prob(self, x):
        (p,) = _bc(self.p, like=x)
        return torch.xlogy(x, p) + torch.special.xlog1py(1.0 - x, -p)

    def sample(self, key, shape=()):
        (p,) = _on(key, self.p)
        return (_rand(key, shape, p) < p).to(p.dtype)

    def in_support(self, x):
        return _support(self, x, (x == 0) | (x == 1))

    def support_bounds(self):
        (p,) = _bc(self.p)
        return torch.zeros_like(p), torch.ones_like(p)

    def mean(self):
        return _bc(self.p)[0]


@distribution
class Binomial(DiscreteUnivariateDistribution):
    n: torch.Tensor = 1
    p: torch.Tensor = 0.5

    def log_prob(self, x):
        n, p = _bc(self.n, self.p, like=x)
        logc = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                - torch.lgamma(n - x + 1.0))
        return logc + torch.xlogy(x, p) + torch.special.xlog1py(n - x, -p)

    def sample(self, key, shape=()):
        n, p = _on(key, self.n, self.p)
        return _rbinomial(key, shape, n, p)

    def in_support(self, x):
        n = _bc(self.n, self.p, like=x)[0]
        return (x >= 0) & (x <= n) & _is_int(x)

    def support_bounds(self):
        n, _ = _bc(self.n, self.p)
        return torch.zeros_like(n), n

    def mean(self):
        n, p = _bc(self.n, self.p)
        return n * p


@distribution
class Poisson(DiscreteUnivariateDistribution):
    lam: torch.Tensor = 1.0

    def log_prob(self, x):
        (lam,) = _bc(self.lam, like=x)
        return torch.xlogy(x, lam) - lam - torch.lgamma(x + 1.0)

    def sample(self, key, shape=()):
        (lam,) = _on(key, self.lam)
        return _rpoisson(key, shape, lam)

    def in_support(self, x):
        return _support(self, x, (x >= 0) & _is_int(x))

    def support_bounds(self):
        # unbounded above: enumeration truncates at mean + 10*sd
        (lam,) = _bc(self.lam)
        return torch.zeros_like(lam), torch.ceil(lam + 10.0 * torch.sqrt(lam) + 10.0)

    def mean(self):
        return _bc(self.lam)[0]


@distribution
class Geometric(DiscreteUnivariateDistribution):
    """Number of failures before first success; support {0, 1, ...}."""
    p: torch.Tensor = 0.5

    def log_prob(self, x):
        (p,) = _bc(self.p, like=x)
        return torch.special.xlog1py(x, -p) + torch.log(p)

    def sample(self, key, shape=()):
        (p,) = _on(key, self.p)
        u = _rand(key, shape, p)
        return torch.floor(torch.log1p(-u) / torch.log1p(-p))

    def in_support(self, x):
        return _support(self, x, (x >= 0) & _is_int(x))

    def support_bounds(self):
        (p,) = _bc(self.p)
        return torch.zeros_like(p), torch.ceil(20.0 / p)


@distribution
class NegativeBinomial(DiscreteUnivariateDistribution):
    """r successes, success prob p; counts failures. Mean r(1-p)/p."""
    r: torch.Tensor = 1.0
    p: torch.Tensor = 0.5

    def log_prob(self, x):
        r, p = _bc(self.r, self.p, like=x)
        return (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0)
                + r * torch.log(p) + torch.special.xlog1py(x, -p))

    def sample(self, key, shape=()):
        # gamma-Poisson mixture
        r, p = _on(key, self.r, self.p)
        kg, kp = R.split(key)
        lam = _rgamma(kg, shape, r) * (1.0 - p) / p
        return _rpoisson(kp, (), lam)

    def in_support(self, x):
        return _support(self, x, (x >= 0) & _is_int(x))

    def support_bounds(self):
        r, p = _bc(self.r, self.p)
        m = r * (1.0 - p) / p
        sd = torch.sqrt(m / p)
        return torch.zeros_like(r), torch.ceil(m + 10.0 * sd + 10.0)


@distribution
class Categorical(DiscreteUnivariateDistribution):
    """Support {1, ..., K} with probability vector ``p`` over the last axis
    (1-based to match the reference's Distributions.jl Categorical, used by
    the eyes mixture model doc/examples/eyes.jl)."""
    p: torch.Tensor = None

    @property
    def batch_shape(self):
        return self.p.shape[:-1]

    def log_prob(self, x):
        p = self.p.to(x.dtype) if x.is_floating_point() else self.p
        logp = torch.log(p)
        K = p.shape[-1]
        idx = torch.clamp(x.to(torch.int64) - 1, 0, K - 1)
        full = torch.broadcast_shapes(idx.shape, p.shape[:-1])
        return torch.gather(logp.expand(full + (K,)), -1,
                            idx.expand(full)[..., None])[..., 0]

    def sample(self, key, shape=()):
        p = self.p.to(key.device)
        return (_rcategorical(key, shape, torch.log(p)) + 1).to(p.dtype)

    def in_support(self, x):
        K = self.p.shape[-1]
        return _support(self, x, (x >= 1) & (x <= K) & _is_int(x))

    def support_bounds(self):
        K = self.p.shape[-1]
        shp = tuple(self.batch_shape)
        return (torch.ones(shp, dtype=self.p.dtype, device=self.p.device),
                torch.full(shp, float(K), dtype=self.p.dtype,
                           device=self.p.device))

    def mean(self):
        p = self.p
        k = torch.arange(1, p.shape[-1] + 1, dtype=p.dtype, device=p.device)
        return torch.sum(p * k, dim=-1)


@distribution
class DiscreteUniform(DiscreteUnivariateDistribution):
    a: torch.Tensor = 0
    b: torch.Tensor = 1

    def log_prob(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return (-torch.log(b - a + 1.0)).expand(
            torch.broadcast_shapes(x.shape, a.shape))

    def sample(self, key, shape=()):
        a, b = _on(key, self.a, self.b)
        return a + torch.floor(_rand(key, shape, a) * (b - a + 1.0))

    def in_support(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return (x >= a) & (x <= b) & _is_int(x)

    def support_bounds(self):
        return _bc(self.a, self.b)

    def mean(self):
        a, b = _bc(self.a, self.b)
        return 0.5 * (a + b)


def _logchoose(a, b):
    return torch.lgamma(a + 1.0) - torch.lgamma(b + 1.0) - torch.lgamma(a - b + 1.0)


@distribution
class Hypergeometric(DiscreteUnivariateDistribution):
    """ns successes, nf failures, n draws; X = successes drawn."""
    ns: torch.Tensor = 1
    nf: torch.Tensor = 1
    n: torch.Tensor = 1

    def log_prob(self, x):
        ns, nf, n = _bc(self.ns, self.nf, self.n, like=x)
        return _logchoose(ns, x) + _logchoose(nf, n - x) - _logchoose(ns + nf, n)

    def in_support(self, x):
        lo, hi = (t.to(x.dtype) for t in self.support_bounds())
        return (x >= lo) & (x <= hi) & _is_int(x)

    def support_bounds(self):
        ns, nf, n = _bc(self.ns, self.nf, self.n)
        return torch.clamp(n - nf, min=0.0), torch.minimum(ns, n)

    def sample(self, key, shape=()):
        # categorical draw over the enumerated support; batched parameters
        # share one width (the widest support) and mask each element's tail.
        # The width is read from the parameters, so they must be concrete.
        ns, nf, n = _on(key, self.ns, self.nf, self.n)
        lo, hi = torch.clamp(n - nf, min=0.0), torch.minimum(ns, n)
        kmax = int(torch.max(hi - lo)) + 1
        ks = lo[..., None] + torch.arange(kmax, dtype=ns.dtype, device=ns.device)
        sub = Hypergeometric(ns[..., None], nf[..., None], n[..., None])
        lp = torch.where(ks <= hi[..., None], sub.log_prob(ks),
                         torch.full_like(ks, -torch.inf))
        return lo + _rcategorical(key, shape, lp).to(lo.dtype)
