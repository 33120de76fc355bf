"""Remaining discrete univariate distributions from the reference's import
list (src/Mamba.jl:27-30): PoissonBinomial, Skellam and Fisher's noncentral
hypergeometric.

All three have finite or effectively finite supports: PoissonBinomial builds
its full pmf by convolving over the trials (one pass of n steps over whole
tensors), Skellam sums a fixed-width Poisson-product series with logsumexp,
and NoncentralHypergeometric normalizes over its enumerated support.
"""

from __future__ import annotations

import torch

from .base import (DiscreteUnivariateDistribution, distribution, _bc, _is_int,
                   _on, _rand, _rcategorical, _rpoisson, _support)
from .. import random as R
from .discrete import _logchoose

__all__ = ["PoissonBinomial", "Skellam", "NoncentralHypergeometric"]

_SKELLAM_TERMS = 128


@distribution
class PoissonBinomial(DiscreteUnivariateDistribution):
    """Number of successes among independent Bernoulli(p_i) trials; ``p`` is
    the success-probability vector over the last axis.  The pmf over
    {0..n} is built by stepping through the trial axis and convolving."""
    p: torch.Tensor = None

    @property
    def batch_shape(self):
        return self.p.shape[:-1]

    def _pmf_table(self, dtype=None):
        p = self.p if dtype is None else self.p.to(dtype)
        n = p.shape[-1]
        # pmf over counts 0..n, batched; start as delta at 0
        pmf = torch.cat([torch.ones_like(p[..., :1]),
                         torch.zeros_like(p[..., :1]).expand(p.shape[:-1] + (n,))],
                        dim=-1)
        for i in range(n):
            pi = p[..., i:i + 1]
            shifted = torch.cat([torch.zeros_like(pmf[..., :1]), pmf[..., :-1]],
                                dim=-1)
            pmf = pmf * (1.0 - pi) + shifted * pi
        return pmf

    def log_prob(self, x):
        pmf = self._pmf_table(x.dtype if x.is_floating_point() else None)
        n = pmf.shape[-1] - 1
        idx = torch.clamp(x.to(torch.int64), 0, n)
        full = torch.broadcast_shapes(idx.shape, self.batch_shape)
        out = torch.gather(pmf.expand(full + (n + 1,)), -1,
                           idx.expand(full)[..., None])[..., 0]
        return torch.log(torch.clamp(out, min=1e-37))

    def sample(self, key, shape=()):
        p = self.p.to(key.device)
        u = _rand(key, shape, p)
        return torch.sum((u < p).to(p.dtype), dim=-1)

    def in_support(self, x):
        n = self.p.shape[-1]
        return _support(self, x, (x >= 0) & (x <= n) & _is_int(x))

    def support_bounds(self):
        n = self.p.shape[-1]
        shp = tuple(self.batch_shape)
        f = dict(dtype=self.p.dtype, device=self.p.device)
        return torch.zeros(shp, **f), torch.full(shp, float(n), **f)

    def mean(self):
        return torch.sum(self.p, dim=-1)

    def variance(self):
        return torch.sum(self.p * (1.0 - self.p), dim=-1)


@distribution
class Skellam(DiscreteUnivariateDistribution):
    """Difference of independent Poissons: X = N1(mu1) - N2(mu2), support all
    of Z.  pmf(k) = sum_j Pois(j; mu2) Pois(j + k; mu1), accumulated with a
    fixed-width logsumexp (exact for mu up to about _SKELLAM_TERMS/3)."""
    mu1: torch.Tensor = 1.0
    mu2: torch.Tensor = 1.0

    def log_prob(self, x):
        mu1, mu2 = _bc(self.mu1, self.mu2, like=x)
        nd = max(x.dim(), mu1.dim())
        j = torch.arange(_SKELLAM_TERMS, dtype=x.dtype,
                         device=x.device).reshape((-1,) + (1,) * nd)
        # for k >= 0: j ~ second Poisson, j+k ~ first; mirror for k < 0
        k = torch.abs(x)
        mu_a = torch.where(x >= 0, mu1, mu2)   # gets j + |k|
        mu_b = torch.where(x >= 0, mu2, mu1)   # gets j

        def pois_lp(n, mu):
            return torch.xlogy(n, mu) - mu - torch.lgamma(n + 1.0)

        return torch.logsumexp(pois_lp(j + k, mu_a) + pois_lp(j, mu_b), dim=0)

    def sample(self, key, shape=()):
        mu1, mu2 = _on(key, self.mu1, self.mu2)
        k1, k2 = R.split(key)
        return _rpoisson(k1, shape, mu1) - _rpoisson(k2, shape, mu2)

    def in_support(self, x):
        return _support(self, x, _is_int(x))

    def support_bounds(self):
        # effectively finite support for enumeration: +-8 sd around the mean
        mu1, mu2 = _bc(self.mu1, self.mu2)
        m, sd = mu1 - mu2, torch.sqrt(mu1 + mu2)
        return torch.floor(m - 8.0 * sd), torch.ceil(m + 8.0 * sd)

    def mean(self):
        mu1, mu2 = _bc(self.mu1, self.mu2)
        return mu1 - mu2

    def variance(self):
        mu1, mu2 = _bc(self.mu1, self.mu2)
        return mu1 + mu2


@distribution
class NoncentralHypergeometric(DiscreteUnivariateDistribution):
    """Fisher's noncentral hypergeometric: ns successes / nf failures in the
    urn, n draws, odds ratio ``omega``.  pmf(k) proportional to
    C(ns,k) C(nf,n-k) omega^k, normalized over the enumerated support (of
    width ``max_support``; by default read from the parameters, which must
    then be concrete)."""
    ns: torch.Tensor = 1
    nf: torch.Tensor = 1
    n: torch.Tensor = 1
    omega: torch.Tensor = 1.0
    max_support: int = 0

    def _kwidth(self):
        if self.max_support:
            return self.max_support
        ns, n = _bc(self.ns, self.n)
        return int(torch.max(torch.minimum(ns, n))) + 1

    def _log_weights(self, like=None):
        ns, nf, n, w = _bc(self.ns, self.nf, self.n, self.omega, like=like)
        lo = torch.clamp(n - nf, min=0.0)
        hi = torch.minimum(ns, n)
        ks = lo[..., None] + torch.arange(self._kwidth(), dtype=ns.dtype,
                                          device=ns.device)
        lw = (_logchoose(ns[..., None], ks)
              + _logchoose(nf[..., None], n[..., None] - ks)
              + ks * torch.log(w[..., None]))
        lw = torch.where(ks <= hi[..., None], lw, torch.full_like(lw, -torch.inf))
        return ks, lw - torch.logsumexp(lw, dim=-1, keepdim=True)

    def log_prob(self, x):
        ks, lw = self._log_weights(x)
        lo = ks[..., 0]
        idx = torch.clamp((x - lo).to(torch.int64), 0, ks.shape[-1] - 1)
        full = torch.broadcast_shapes(x.shape, self.batch_shape)
        return torch.gather(lw.expand(full + lw.shape[-1:]), -1,
                            idx.expand(full)[..., None])[..., 0]

    def sample(self, key, shape=()):
        ks, lw = (t.to(key.device) for t in self._log_weights())
        return ks[..., 0] + _rcategorical(key, shape, lw).to(ks.dtype)

    def in_support(self, x):
        lo, hi = (t.to(x.dtype) for t in self.support_bounds())
        return (x >= lo) & (x <= hi) & _is_int(x)

    def support_bounds(self):
        ns, nf, n, _ = _bc(self.ns, self.nf, self.n, self.omega)
        return torch.clamp(n - nf, min=0.0), torch.minimum(ns, n)

    def mean(self):
        ks, lw = self._log_weights()
        return torch.sum(ks * torch.exp(lw), dim=-1)
