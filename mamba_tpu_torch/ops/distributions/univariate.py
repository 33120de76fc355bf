"""Continuous univariate distributions (batched torch).

Replaces the reference's use of Distributions.jl univariates (imported in
src/Mamba.jl:8-44) plus its extension types ``Flat``/``SymUniform``
(src/distributions/extensions.jl:3-55).  Every log_prob is one elementwise
expression over arbitrarily batched parameters.

``torch.special.gammainc`` and ``gammaincc`` have no derivative in their
first argument, so the cdf of ``Gamma``, ``InverseGamma`` and ``Chisq`` (and
a ``Truncated`` of them) differentiates in ``x`` and the scale only.  No
model of the package differentiates through a truncated Gamma's shape.
"""

from __future__ import annotations

import math

import torch

from ...utils.math import betainc
from .. import bijectors as bij
from .base import (Distribution, UnivariateDistribution, distribution, _bc,
                   _on, _rand, _randn, _rexp, _rgamma, _support, param_like)

__all__ = [
    "Normal", "LogNormal", "Exponential", "Gamma", "InverseGamma", "Beta",
    "Uniform", "Cauchy", "Laplace", "Logistic", "TDist", "Chisq", "Weibull",
    "Pareto", "Gumbel", "Flat", "SymUniform", "Truncated",
]

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
        mu, sigma = _on(gen, self.mu, self.sigma)
        return mu + sigma * _randn(gen, shape, mu)

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
class LogNormal(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        lx = torch.log(x)
        z = (lx - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - _HALF_LOG_2PI - lx

    def sample(self, gen, shape=()):
        mu, sigma = _on(gen, self.mu, self.sigma)
        return torch.exp(mu + sigma * _randn(gen, shape, mu))

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        return torch.special.ndtr((torch.log(x) - mu) / sigma)

    def icdf(self, q):
        mu, sigma = _bc(self.mu, self.sigma, like=q)
        return torch.exp(mu + sigma * torch.special.ndtri(q))

    def mean(self):
        mu, sigma = _bc(self.mu, self.sigma)
        return torch.exp(mu + 0.5 * sigma * sigma)


@distribution
class Exponential(UnivariateDistribution):
    """``theta`` is the Distributions.jl *scale* convention:
    Exponential(theta) has mean theta."""
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        (theta,) = _bc(self.theta, like=x)
        return -x / theta - torch.log(theta)

    def sample(self, gen, shape=()):
        (theta,) = _on(gen, self.theta)
        return theta * _rexp(gen, shape, theta)

    def in_support(self, x):
        return _support(self, x, x >= 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        (theta,) = _bc(self.theta, like=x)
        return -torch.expm1(-x / theta)

    def icdf(self, q):
        (theta,) = _bc(self.theta, like=q)
        return -theta * torch.log1p(-q)

    def mean(self):
        return _bc(self.theta)[0]


@distribution
class Gamma(UnivariateDistribution):
    """shape alpha, *scale* theta (Distributions.jl convention: mean = a*theta)."""
    alpha: torch.Tensor = 1.0
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return torch.xlogy(a - 1.0, x) - x / t - torch.lgamma(a) - a * torch.log(t)

    def sample(self, gen, shape=()):
        a, t = _on(gen, self.alpha, self.theta)
        return t * _rgamma(gen, shape, a)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return torch.special.gammainc(a, x / t)

    def mean(self):
        a, t = _bc(self.alpha, self.theta)
        return a * t

    def variance(self):
        a, t = _bc(self.alpha, self.theta)
        return a * t * t


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
        a, b = _on(gen, self.alpha, self.beta)
        return b / _rgamma(gen, shape, a)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return torch.special.gammaincc(a, b / x)

    def mean(self):
        a, b = _bc(self.alpha, self.beta)
        return b / (a - 1.0)


@distribution
class Beta(UnivariateDistribution):
    alpha: torch.Tensor = 1.0
    beta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return (torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
                - torch.lgamma(a) - torch.lgamma(b) + torch.lgamma(a + b))

    def sample(self, gen, shape=()):
        a, b = _on(gen, self.alpha, self.beta)
        g1 = _rgamma(gen, shape, a)
        g2 = _rgamma(gen, shape, b)
        return g1 / (g1 + g2)

    def in_support(self, x):
        return _support(self, x, (x > 0) & (x < 1))

    def bijector(self):
        z = torch.zeros_like(_bc(self.alpha, self.beta)[0])
        return bij.Sigmoid(z, z + 1.0)

    def cdf(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return betainc(a, b, torch.clamp(x, 0.0, 1.0))

    def mean(self):
        a, b = _bc(self.alpha, self.beta)
        return a / (a + b)


@distribution
class Uniform(UnivariateDistribution):
    a: torch.Tensor = 0.0
    b: torch.Tensor = 1.0

    def log_prob(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return (-torch.log(b - a)).expand(
            torch.broadcast_shapes(x.shape, a.shape))

    def sample(self, gen, shape=()):
        a, b = _on(gen, self.a, self.b)
        return a + (b - a) * _rand(gen, shape, a)

    def in_support(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return (x >= a) & (x <= b)

    def bijector(self):
        a, b = _bc(self.a, self.b)
        return bij.Sigmoid(a, b)

    def cdf(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return torch.clamp((x - a) / (b - a), 0.0, 1.0)

    def icdf(self, q):
        a, b = _bc(self.a, self.b, like=q)
        return a + q * (b - a)

    def mean(self):
        a, b = _bc(self.a, self.b)
        return 0.5 * (a + b)


@distribution
class Cauchy(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        z = (x - mu) / sigma
        return -torch.log(math.pi * sigma * (1.0 + z * z))

    def sample(self, gen, shape=()):
        mu, sigma = _on(gen, self.mu, self.sigma)
        return self.icdf(_rand(gen, shape, mu))

    def cdf(self, x):
        mu, sigma = _bc(self.mu, self.sigma, like=x)
        return 0.5 + torch.arctan((x - mu) / sigma) / math.pi

    def icdf(self, q):
        mu, sigma = _bc(self.mu, self.sigma, like=q)
        return mu + sigma * torch.tan(math.pi * (q - 0.5))


@distribution
class Laplace(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    beta: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, b = _bc(self.mu, self.beta, like=x)
        return -torch.abs(x - mu) / b - torch.log(2.0 * b)

    def sample(self, gen, shape=()):
        mu, _ = _on(gen, self.mu, self.beta)
        return self.icdf(_rand(gen, shape, mu))

    def cdf(self, x):
        mu, b = _bc(self.mu, self.beta, like=x)
        z = (x - mu) / b
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def icdf(self, q):
        mu, b = _bc(self.mu, self.beta, like=q)
        return mu - b * torch.sign(q - 0.5) * torch.log1p(-2.0 * torch.abs(q - 0.5))

    def mean(self):
        return _bc(self.mu, self.beta)[0]


@distribution
class Logistic(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, t = _bc(self.mu, self.theta, like=x)
        z = (x - mu) / t
        return -z - 2.0 * bij.softplus(-z) - torch.log(t)

    def sample(self, gen, shape=()):
        mu, _ = _on(gen, self.mu, self.theta)
        u = 1.0 - _rand(gen, shape, mu)          # (0, 1]
        return self.icdf(torch.clamp(u, max=1.0 - torch.finfo(u.dtype).eps))

    def cdf(self, x):
        mu, t = _bc(self.mu, self.theta, like=x)
        return torch.sigmoid((x - mu) / t)

    def icdf(self, q):
        mu, t = _bc(self.mu, self.theta, like=q)
        return mu + t * (torch.log(q) - torch.log1p(-q))

    def mean(self):
        return _bc(self.mu, self.theta)[0]


@distribution
class TDist(UnivariateDistribution):
    """Student-t with ``nu`` degrees of freedom (standardized, like
    Distributions.jl TDist)."""
    nu: torch.Tensor = 1.0

    def log_prob(self, x):
        (nu,) = _bc(self.nu, like=x)
        return (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
                - 0.5 * torch.log(nu * math.pi)
                - 0.5 * (nu + 1.0) * torch.log1p(x * x / nu))

    def sample(self, gen, shape=()):
        (nu,) = _on(gen, self.nu)
        z = _randn(gen, shape, nu)
        return z / torch.sqrt(2.0 * _rgamma(gen, shape, 0.5 * nu) / nu)

    def mean(self):
        (nu,) = _bc(self.nu)
        return torch.zeros_like(nu)


@distribution
class Chisq(UnivariateDistribution):
    nu: torch.Tensor = 1.0

    def log_prob(self, x):
        (nu,) = _bc(self.nu, like=x)
        h = 0.5 * nu
        return (torch.xlogy(h - 1.0, x) - 0.5 * x - torch.lgamma(h)
                - h * math.log(2.0))

    def sample(self, gen, shape=()):
        (nu,) = _on(gen, self.nu)
        return 2.0 * _rgamma(gen, shape, 0.5 * nu)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        (nu,) = _bc(self.nu, like=x)
        return torch.special.gammainc(0.5 * nu, 0.5 * x)

    def mean(self):
        return _bc(self.nu)[0]


@distribution
class Weibull(UnivariateDistribution):
    """shape alpha, scale theta."""
    alpha: torch.Tensor = 1.0
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        z = x / t
        return torch.log(a / t) + torch.xlogy(a - 1.0, z) - z ** a

    def sample(self, gen, shape=()):
        a, _ = _on(gen, self.alpha, self.theta)
        return self.icdf(_rand(gen, shape, a))

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return -torch.expm1(-((x / t) ** a))

    def icdf(self, q):
        a, t = _bc(self.alpha, self.theta, like=q)
        return t * (-torch.log1p(-q)) ** (1.0 / a)

    def sf(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return torch.exp(-((x / t) ** a))

    def isf(self, s):
        a, t = _bc(self.alpha, self.theta, like=s)
        return t * (-torch.log(s)) ** (1.0 / a)


@distribution
class Pareto(UnivariateDistribution):
    """shape alpha, scale (minimum) theta."""
    alpha: torch.Tensor = 1.0
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return torch.log(a) + a * torch.log(t) - (a + 1.0) * torch.log(x)

    def sample(self, gen, shape=()):
        a, _ = _on(gen, self.alpha, self.theta)
        return self.icdf(_rand(gen, shape, a))

    def in_support(self, x):
        t = _bc(self.alpha, self.theta, like=x)[1]
        return x >= t

    def bijector(self):
        return bij.LowerBounded(_bc(self.alpha, self.theta)[1])

    def cdf(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return 1.0 - (t / x) ** a

    def icdf(self, q):
        a, t = _bc(self.alpha, self.theta, like=q)
        return t * (1.0 - q) ** (-1.0 / a)


@distribution
class Gumbel(UnivariateDistribution):
    mu: torch.Tensor = 0.0
    beta: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, b = _bc(self.mu, self.beta, like=x)
        z = (x - mu) / b
        return -z - torch.exp(-z) - torch.log(b)

    def sample(self, gen, shape=()):
        mu, b = _on(gen, self.mu, self.beta)
        return mu - b * torch.log(_rexp(gen, shape, mu))

    def cdf(self, x):
        mu, b = _bc(self.mu, self.beta, like=x)
        return torch.exp(-torch.exp(-(x - mu) / b))

    def icdf(self, q):
        mu, b = _bc(self.mu, self.beta, like=q)
        return mu - b * torch.log(-torch.log(q))


@distribution
class Flat(UnivariateDistribution):
    """Improper flat prior on the whole real line
    (reference: src/distributions/extensions.jl:3-13)."""

    def log_prob(self, x):
        return torch.zeros_like(x)

    def sample(self, gen, shape=()):
        # the reference errors on rand(Flat); N(0, 1) serves initialization
        return torch.randn(tuple(shape), generator=gen, device=gen.device)

    def mean(self):
        return torch.zeros(())


@distribution
class SymUniform(UnivariateDistribution):
    """Uniform on [mu - scale, mu + scale]
    (reference: src/distributions/extensions.jl:43-46)."""
    mu: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0

    def _ab(self, like=None):
        mu, s = _bc(self.mu, self.scale, like=like)
        return mu - s, mu + s

    def log_prob(self, x):
        a, b = self._ab(x)
        return (-torch.log(b - a)).expand(
            torch.broadcast_shapes(x.shape, a.shape))

    def sample(self, gen, shape=()):
        a, b = (t.to(gen.device) for t in self._ab())
        return a + (b - a) * _rand(gen, shape, a)

    def in_support(self, x):
        a, b = self._ab(x)
        return (x >= a) & (x <= b)

    def bijector(self):
        return bij.Sigmoid(*self._ab())


def _all_finite(v) -> bool:
    """Whether a truncation bound is finite everywhere, decided on the host.
    A Python number costs nothing.  A concrete tensor (a model input) is
    read once and the answer kept on the tensor, so that a density called
    in every step of a run does not wait for the device.  A tensor that
    ``torch.func`` has wrapped (a per-chain value under ``vmap``, or one
    that is being differentiated) has no value to read."""
    if not isinstance(v, torch.Tensor):
        return math.isfinite(v)
    if torch._C._functorch.is_functorch_wrapped_tensor(v):
        raise ValueError(
            "Truncated.bijector() needs bounds whose finiteness is known "
            "when the model is compiled: Python numbers or model inputs.  "
            "A bound that is another node's per-chain value cannot choose "
            "the transform; sample such a node untransformed (e.g. Slice).")
    known = getattr(v, "_all_finite", None)
    if known is None:
        known = bool(torch.isfinite(v).all())
        v._all_finite = known
    return known


@distribution
class Truncated(UnivariateDistribution):
    """Truncation of a continuous univariate base distribution to [lo, hi]
    (reference: TransformDistribution includes Truncated,
    transformdistribution.jl:6-11).  Bounds may be +-inf."""
    base: Distribution
    lo: torch.Tensor = -math.inf
    hi: torch.Tensor = math.inf

    def _log_mass(self, like):
        lo, hi = _bc(self.lo, self.hi, like=like)
        one, zero = torch.ones_like(lo), torch.zeros_like(lo)
        if hasattr(self.base, "sf"):
            # sf-space mass: exact for right-tail truncation where
            # cdf(lo) -> 1 loses all precision
            sf_lo = torch.where(torch.isfinite(lo), self.base.sf(lo), one)
            sf_hi = torch.where(torch.isfinite(hi), self.base.sf(hi), zero)
            return torch.log(sf_lo - sf_hi), 1.0 - sf_lo, 1.0 - sf_hi
        cdf_lo = torch.where(torch.isfinite(lo), self.base.cdf(lo), zero)
        cdf_hi = torch.where(torch.isfinite(hi), self.base.cdf(hi), one)
        return torch.log(cdf_hi - cdf_lo), cdf_lo, cdf_hi

    def log_prob(self, x):
        if not hasattr(self.base, "cdf"):
            # improper base (e.g. Truncated(Flat(), ...), dogs.jl:60-70):
            # no normalizing mass exists; density is the base's, support-
            # restricted (restriction enforced via in_support).
            return self.base.log_prob(x)
        lm, _, _ = self._log_mass(x)
        return self.base.log_prob(x) - lm

    def sample(self, gen, shape=()):
        like = param_like(self, gen.device)
        lo, hi = (t.to(gen.device) for t in _bc(self.lo, self.hi, like=like))
        if not hasattr(self.base, "cdf"):
            # improper base: draws exist only for initialization; land just
            # inside the truncation region (the reference errors here).
            lo_f, hi_f = torch.isfinite(lo), torch.isfinite(hi)
            e = _rexp(gen, shape, lo)
            u = _rand(gen, shape, lo)
            z = _randn(gen, shape, lo)
            zero = torch.zeros_like(u)
            both = torch.where(lo_f & hi_f, lo + u * (hi - lo), zero)
            low_only = torch.where(lo_f & ~hi_f, lo + e, zero)
            hi_only = torch.where(~lo_f & hi_f, hi - e, zero)
            neither = torch.where(~lo_f & ~hi_f, z, zero)
            return both + low_only + hi_only + neither
        if hasattr(self.base, "sf") and hasattr(self.base, "isf"):
            # survival-space sampling: numerically exact deep in the right
            # tail (cdf_lo -> 1 rounds q to 1.0 in f32 and yields inf draws;
            # e.g. mice.jl censoring at 40 with scale ~3)
            sf_lo = torch.where(torch.isfinite(lo), self.base.sf(lo),
                                torch.ones_like(lo))
            sf_hi = torch.where(torch.isfinite(hi), self.base.sf(hi),
                                torch.zeros_like(lo))
            u = _rand(gen, shape, sf_lo)
            s = sf_hi + (1.0 - u) * (sf_lo - sf_hi)
            return self.base.isf(s)
        _, cdf_lo, cdf_hi = self._log_mass(like)
        cdf_lo, cdf_hi = cdf_lo.to(gen.device), cdf_hi.to(gen.device)
        u = _rand(gen, shape, cdf_lo)
        q = torch.clamp(cdf_lo + u * (cdf_hi - cdf_lo),
                        max=1.0 - torch.finfo(cdf_lo.dtype).eps / 2)
        if hasattr(self.base, "icdf"):
            return self.base.icdf(q)
        return _bisect_icdf(self.base, q, lo, hi)

    def in_support(self, x):
        lo, hi = _bc(self.lo, self.hi, like=x)
        return self.base.in_support(x) & (x >= lo) & (x <= hi)

    def bijector(self):
        lo_f, hi_f = _all_finite(self.lo), _all_finite(self.hi)
        if lo_f and hi_f:
            return bij.Sigmoid(*_bc(self.lo, self.hi))
        if lo_f:
            return bij.LowerBounded(torch.as_tensor(self.lo))
        if hi_f:
            return bij.UpperBounded(torch.as_tensor(self.hi))
        return self.base.bijector()


def _bisect_icdf(base, q, lo, hi, iters=60):
    """Bisection inverse-cdf fallback for bases without icdf: a fixed number
    of halvings of [lo, hi] (infinite bounds start at +-1e10)."""
    lo = torch.as_tensor(lo, dtype=q.dtype, device=q.device)
    hi = torch.as_tensor(hi, dtype=q.dtype, device=q.device)
    l = torch.where(torch.isfinite(lo), lo, torch.full_like(lo, -1e10)).expand(q.shape)
    h = torch.where(torch.isfinite(hi), hi, torch.full_like(hi, 1e10)).expand(q.shape)
    for _ in range(iters):
        m = 0.5 * (l + h)
        below = base.cdf(m) < q
        l, h = torch.where(below, m, l), torch.where(below, h, m)
    return 0.5 * (l + h)
