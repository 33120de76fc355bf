"""Remaining continuous univariate distributions from the reference's import
list.

The reference re-exports every Distributions.jl univariate usable in node
declarations (src/Mamba.jl:12-37): beyond the common families in
``univariate.py`` that list includes Arcsine, BetaPrime, the kernel-density
families (Biweight, Cosine, Epanechnikov, Triweight), Chi, Erlang, FDist,
Frechet, InverseGaussian, the Kolmogorov-Smirnov laws, Levy, the noncentral
family, NormalCanon, Rayleigh, the triangular laws and VonMises.  This module
supplies them as batched torch expressions following the same protocol.

Noncentral log-densities are evaluated as Poisson mixtures with a fixed-width
``logsumexp`` series (accurate for noncentrality ``lambda`` up to about
2 * _SERIES_TERMS).  Kolmogorov-law tails use the classical Jacobi theta
series.  Every bisection and rejection loop runs a fixed number of rounds
over whole tensors.
"""

from __future__ import annotations

import math

import torch

from ...utils.math import betainc
from .. import bijectors as bij
from .base import (UnivariateDistribution, distribution, _bc, _on, _rand,
                   _randn, _rgamma, _rpoisson, _support)
from .univariate import Gamma, Normal, _HALF_LOG_2PI

__all__ = [
    "Arcsine", "BetaPrime", "Biweight", "Chi", "Cosine", "Epanechnikov",
    "Erlang", "FDist", "Frechet", "InverseGaussian", "Kolmogorov", "KSDist",
    "KSOneSided", "Levy", "NoncentralBeta", "NoncentralChisq", "NoncentralF",
    "NoncentralT", "NormalCanon", "Rayleigh", "SymTriangularDist",
    "TriangularDist", "Triweight", "VonMises",
]

_SERIES_TERMS = 64  # Poisson-mixture truncation for noncentral families


def _series_index(terms, like, ndim):
    """``0 .. terms-1`` along a new leading axis over ``ndim`` value dims."""
    j = torch.arange(terms, dtype=like.dtype, device=like.device)
    return j.reshape((-1,) + (1,) * ndim)


def _pois_logpmf(j, lam):
    return torch.xlogy(j, lam) - lam - torch.lgamma(j + 1.0)


def _bisect(cdf, q, lo, hi, rounds):
    """Inverse of an increasing ``cdf`` at ``q`` by ``rounds`` halvings of
    [lo, hi]."""
    l = torch.full_like(q, lo)
    h = torch.full_like(q, hi)
    for _ in range(rounds):
        m = 0.5 * (l + h)
        below = cdf(m) < q
        l, h = torch.where(below, m, l), torch.where(below, h, m)
    return 0.5 * (l + h)


@distribution
class Arcsine(UnivariateDistribution):
    """Arcsine law on [a, b]: pdf = 1 / (pi sqrt((x-a)(b-x)))."""
    a: torch.Tensor = 0.0
    b: torch.Tensor = 1.0

    def log_prob(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return -math.log(math.pi) - 0.5 * (torch.log(x - a) + torch.log(b - x))

    def sample(self, gen, shape=()):
        a, _ = _on(gen, self.a, self.b)
        return self.icdf(_rand(gen, shape, a))

    def in_support(self, x):
        a, b = _bc(self.a, self.b, like=x)
        return (x > a) & (x < b)

    def bijector(self):
        return bij.Sigmoid(*_bc(self.a, self.b))

    def cdf(self, x):
        a, b = _bc(self.a, self.b, like=x)
        z = torch.clamp((x - a) / (b - a), 0.0, 1.0)
        return 2.0 / math.pi * torch.arcsin(torch.sqrt(z))

    def icdf(self, q):
        a, b = _bc(self.a, self.b, like=q)
        s = torch.sin(0.5 * math.pi * q)
        return a + (b - a) * s * s

    def mean(self):
        a, b = _bc(self.a, self.b)
        return 0.5 * (a + b)


@distribution
class BetaPrime(UnivariateDistribution):
    """pdf = x^(a-1) (1+x)^-(a+b) / B(a, b), x > 0 (ratio of Gammas)."""
    alpha: torch.Tensor = 1.0
    beta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return (torch.xlogy(a - 1.0, x) - (a + b) * torch.log1p(x)
                - torch.lgamma(a) - torch.lgamma(b) + torch.lgamma(a + b))

    def sample(self, gen, shape=()):
        a, b = _on(gen, self.alpha, self.beta)
        return _rgamma(gen, shape, a) / _rgamma(gen, shape, b)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, b = _bc(self.alpha, self.beta, like=x)
        return betainc(a, b, x / (1.0 + x))

    def mean(self):
        a, b = _bc(self.alpha, self.beta)
        return a / (b - 1.0)


class _KernelDistribution(UnivariateDistribution):
    """Shared scaffolding for the compact kernel-density families
    (Biweight/Cosine/Epanechnikov/Triweight): location mu, scale sigma,
    support [mu - sigma, mu + sigma].  Subclasses define the standardized
    log-kernel on z in [-1, 1] and its cdf; sampling is inverse-cdf by
    bisection (40 rounds)."""

    def _z(self, x):
        mu, s = _bc(self.mu, self.sigma, like=x)
        return (x - mu) / s, s

    def log_prob(self, x):
        z, s = self._z(x)
        return self._log_kernel(torch.clamp(z, -1.0, 1.0)) - torch.log(s)

    def in_support(self, x):
        mu, s = _bc(self.mu, self.sigma, like=x)
        return (x >= mu - s) & (x <= mu + s)

    def bijector(self):
        mu, s = _bc(self.mu, self.sigma)
        return bij.Sigmoid(mu - s, mu + s)

    def cdf(self, x):
        z, _ = self._z(x)
        return self._kernel_cdf(torch.clamp(z, -1.0, 1.0))

    def sample(self, gen, shape=()):
        mu, s = _on(gen, self.mu, self.sigma)
        q = _rand(gen, shape, mu)
        return mu + s * _bisect(self._kernel_cdf, q, -1.0, 1.0, 40)

    def mean(self):
        return _bc(self.mu, self.sigma)[0]


@distribution
class Biweight(_KernelDistribution):
    """Quartic (biweight) kernel: pdf = (15/16)(1 - z^2)^2 / sigma."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def _log_kernel(self, z):
        return math.log(15.0 / 16.0) + 2.0 * torch.log1p(-z * z)

    def _kernel_cdf(self, z):
        return 0.0625 * (3.0 * z ** 5 - 10.0 * z ** 3 + 15.0 * z + 8.0)


@distribution
class Cosine(_KernelDistribution):
    """Raised-cosine: pdf = (1 + cos(pi z)) / (2 sigma) on [mu-sigma, mu+sigma]."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def _log_kernel(self, z):
        return torch.log1p(torch.cos(math.pi * z)) - math.log(2.0)

    def _kernel_cdf(self, z):
        return 0.5 * (1.0 + z + torch.sin(math.pi * z) / math.pi)


@distribution
class Epanechnikov(_KernelDistribution):
    """Parabolic kernel: pdf = (3/4)(1 - z^2) / sigma."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def _log_kernel(self, z):
        return math.log(0.75) + torch.log1p(-z * z)

    def _kernel_cdf(self, z):
        return 0.25 * (2.0 + 3.0 * z - z ** 3)


@distribution
class Triweight(_KernelDistribution):
    """pdf = (35/32)(1 - z^2)^3 / sigma."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def _log_kernel(self, z):
        return math.log(35.0 / 32.0) + 3.0 * torch.log1p(-z * z)

    def _kernel_cdf(self, z):
        return (-5.0 * z ** 7 + 21.0 * z ** 5 - 35.0 * z ** 3 + 35.0 * z + 16.0) / 32.0


@distribution
class Chi(UnivariateDistribution):
    """Chi law with nu dof: X = sqrt(Chisq(nu)).  Its cdf differentiates in
    ``x`` only (``torch.special.gammainc`` has no derivative in its first
    argument)."""
    nu: torch.Tensor = 1.0

    def log_prob(self, x):
        (nu,) = _bc(self.nu, like=x)
        h = 0.5 * nu
        return (torch.xlogy(nu - 1.0, x) - 0.5 * x * x
                - (h - 1.0) * math.log(2.0) - torch.lgamma(h))

    def sample(self, gen, shape=()):
        (nu,) = _on(gen, self.nu)
        return torch.sqrt(2.0 * _rgamma(gen, shape, 0.5 * nu))

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        (nu,) = _bc(self.nu, like=x)
        return torch.special.gammainc(0.5 * nu, 0.5 * x * x)

    def mean(self):
        (nu,) = _bc(self.nu)
        return math.sqrt(2.0) * torch.exp(torch.lgamma(0.5 * (nu + 1.0))
                                          - torch.lgamma(0.5 * nu))


def Erlang(alpha=1, theta=1.0):
    """Erlang(k, theta) = Gamma with integer shape (Distributions.jl alias)."""
    return Gamma(alpha=alpha, theta=theta)


@distribution
class FDist(UnivariateDistribution):
    """Fisher-Snedecor F(nu1, nu2)."""
    nu1: torch.Tensor = 1.0
    nu2: torch.Tensor = 1.0

    def log_prob(self, x):
        n1, n2 = _bc(self.nu1, self.nu2, like=x)
        h1, h2 = 0.5 * n1, 0.5 * n2
        return (h1 * torch.log(n1 / n2) + torch.xlogy(h1 - 1.0, x)
                - (h1 + h2) * torch.log1p(n1 * x / n2)
                - torch.lgamma(h1) - torch.lgamma(h2) + torch.lgamma(h1 + h2))

    def sample(self, gen, shape=()):
        n1, n2 = _on(gen, self.nu1, self.nu2)
        g1 = _rgamma(gen, shape, 0.5 * n1)
        g2 = _rgamma(gen, shape, 0.5 * n2)
        return (g1 / n1) / (g2 / n2)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        n1, n2 = _bc(self.nu1, self.nu2, like=x)
        return betainc(0.5 * n1, 0.5 * n2, n1 * x / (n1 * x + n2))

    def mean(self):
        _, n2 = _bc(self.nu1, self.nu2)
        return n2 / (n2 - 2.0)


@distribution
class Frechet(UnivariateDistribution):
    """Inverse Weibull: shape alpha, scale theta."""
    alpha: torch.Tensor = 1.0
    theta: torch.Tensor = 1.0

    def log_prob(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        z = x / t
        return torch.log(a / t) - (1.0 + a) * torch.log(z) - z ** (-a)

    def sample(self, gen, shape=()):
        a, _ = _on(gen, self.alpha, self.theta)
        return self.icdf(1.0 - _rand(gen, shape, a))

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        a, t = _bc(self.alpha, self.theta, like=x)
        return torch.exp(-((x / t) ** (-a)))

    def icdf(self, q):
        a, t = _bc(self.alpha, self.theta, like=q)
        return t * (-torch.log(q)) ** (-1.0 / a)


@distribution
class InverseGaussian(UnivariateDistribution):
    """Wald law: mean mu, shape lam."""
    mu: torch.Tensor = 1.0
    lam: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, lam = _bc(self.mu, self.lam, like=x)
        d = x - mu
        return (0.5 * torch.log(lam) - _HALF_LOG_2PI - 1.5 * torch.log(x)
                - lam * d * d / (2.0 * mu * mu * x))

    def sample(self, gen, shape=()):
        # Michael-Schucany-Haas (1976): a transformed normal and one
        # uniform that picks between the two roots
        mu, lam = _on(gen, self.mu, self.lam)
        z = _randn(gen, shape, mu)
        y = z * z
        x = (mu + mu * mu * y / (2.0 * lam)
             - mu / (2.0 * lam) * torch.sqrt(4.0 * mu * lam * y + mu * mu * y * y))
        u = _rand(gen, (), x)
        return torch.where(u <= mu / (mu + x), x, mu * mu / x)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        mu, lam = _bc(self.mu, self.lam, like=x)
        rt = torch.sqrt(lam / x)
        return (torch.special.ndtr(rt * (x / mu - 1.0))
                + torch.exp(2.0 * lam / mu) * torch.special.ndtr(-rt * (x / mu + 1.0)))

    def mean(self):
        return _bc(self.mu, self.lam)[0]

    def variance(self):
        mu, lam = _bc(self.mu, self.lam)
        return mu ** 3 / lam


def _kolmogorov_series(x, terms):
    k = torch.arange(1, terms + 1, dtype=x.dtype, device=x.device)
    signs = torch.where(k % 2 == 1, 1.0, -1.0).to(x.dtype)
    return k, signs, x[..., None]


def _kolmogorov_cdf(x, terms=12):
    """P(K <= x) = 1 - 2 sum_{k>=1} (-1)^(k-1) exp(-2 k^2 x^2)."""
    k, signs, xx = _kolmogorov_series(x, terms)
    s = torch.sum(signs * torch.exp(-2.0 * k * k * xx * xx), dim=-1)
    return torch.clamp(1.0 - 2.0 * s, 0.0, 1.0)


def _kolmogorov_logpdf(x, terms=12):
    """d/dx of the theta series: pdf = 8 x sum (-1)^(k-1) k^2 exp(-2 k^2 x^2)."""
    k, signs, xx = _kolmogorov_series(x, terms)
    s = torch.sum(signs * k * k * torch.exp(-2.0 * k * k * xx * xx), dim=-1)
    return math.log(8.0) + torch.log(x) + torch.log(torch.clamp(s, min=1e-37))


def _rand_between(gen, shape, lo, hi):
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return lo + (hi - lo) * u


@distribution
class Kolmogorov(UnivariateDistribution):
    """Asymptotic Kolmogorov sup-distance law (Jacobi theta series)."""

    def log_prob(self, x):
        return _kolmogorov_logpdf(x)

    def cdf(self, x):
        return _kolmogorov_cdf(x)

    def sample(self, gen, shape=()):
        q = _rand_between(gen, shape, 1e-6, 1.0 - 1e-7)
        return _bisect(_kolmogorov_cdf, q, 0.01, 4.0, 50)

    def in_support(self, x):
        return x > 0

    def bijector(self):
        return bij.Exp()

    def mean(self):
        return torch.as_tensor(math.sqrt(math.pi / 2.0) * math.log(2.0))


def _stephens(n):
    """Stephens (1970) finite-n factor: sqrt(n) + 0.12 + 0.11 / sqrt(n)."""
    rn = math.sqrt(float(n))
    return rn + 0.12 + 0.11 / rn


@distribution
class KSDist(UnivariateDistribution):
    """Finite-sample two-sided KS statistic law for sample size n,
    via the asymptotic theta series with the Stephens (1970) finite-n
    correction sqrt(n) x -> x(sqrt(n) + 0.12 + 0.11/sqrt(n))."""
    n: int = 1

    def log_prob(self, x):
        c = _stephens(self.n)
        return _kolmogorov_logpdf(x * c) + math.log(c)

    def cdf(self, x):
        return _kolmogorov_cdf(x * _stephens(self.n))

    def sample(self, gen, shape=()):
        return Kolmogorov().sample(gen, shape) / _stephens(self.n)

    def in_support(self, x):
        return (x > 0) & (x <= 1)

    def bijector(self):
        return bij.Sigmoid(torch.as_tensor(0.0), torch.as_tensor(1.0))


@distribution
class KSOneSided(UnivariateDistribution):
    """One-sided KS law for sample size n: **exact** Birnbaum-Tingey (1951)
    survival function
        P(D+ >= x) = (1-x)^n
                   + x sum_{j=1..n} C(n,j) (x + j/n)^(j-1) (1 - x - j/n)^(n-j)
    (terms with 1 - x - j/n <= 0 vanish); the whole sum is one masked
    reduction, and the density is its derivative by autodiff."""
    n: int = 1

    def _sf(self, x):
        n = self.n
        nf = float(n)
        x = torch.clamp(x, 1e-12, 1.0)
        j = torch.arange(1, n + 1, dtype=x.dtype, device=x.device).reshape(
            (-1,) + (1,) * x.dim())
        r = 1.0 - x - j / nf
        logc = (math.lgamma(nf + 1.0) - torch.lgamma(j + 1.0)
                - torch.lgamma(nf - j + 1.0))
        log_terms = (logc + torch.xlogy(j - 1.0, x + j / nf)
                     + torch.xlogy(nf - j, torch.clamp(r, min=1e-300)))
        terms = torch.where(r > 0, torch.exp(log_terms),
                            torch.zeros_like(log_terms))
        return torch.clamp((1.0 - x) ** n + x * torch.sum(terms, dim=0), 0.0, 1.0)

    def cdf(self, x):
        return 1.0 - self._sf(x)

    def log_prob(self, x):
        # the survival function is elementwise, so the gradient of its sum
        # is the elementwise derivative
        pdf = -torch.func.grad(lambda t: self._sf(t).sum())(x)
        return torch.log(torch.clamp(pdf, min=1e-300))

    def sample(self, gen, shape=()):
        q = _rand_between(gen, shape, 1e-6, 1.0 - 1e-6)
        return _bisect(self.cdf, q, 0.0, 1.0, 50)

    def in_support(self, x):
        return (x > 0) & (x <= 1)

    def bijector(self):
        return bij.Sigmoid(torch.as_tensor(0.0), torch.as_tensor(1.0))


@distribution
class Levy(UnivariateDistribution):
    """Levy alpha=1/2 stable: location mu, scale sigma."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, s = _bc(self.mu, self.sigma, like=x)
        d = x - mu
        return 0.5 * torch.log(s) - _HALF_LOG_2PI - 1.5 * torch.log(d) - 0.5 * s / d

    def sample(self, gen, shape=()):
        mu, s = _on(gen, self.mu, self.sigma)
        z = _randn(gen, shape, mu)
        return mu + s / (z * z)

    def in_support(self, x):
        mu = _bc(self.mu, self.sigma, like=x)[0]
        return x > mu

    def bijector(self):
        return bij.LowerBounded(_bc(self.mu, self.sigma)[0])

    def cdf(self, x):
        mu, s = _bc(self.mu, self.sigma, like=x)
        return 2.0 * torch.special.ndtr(-torch.sqrt(s / (x - mu)))

    def icdf(self, q):
        mu, s = _bc(self.mu, self.sigma, like=q)
        z = torch.special.ndtri(0.5 * q)
        return mu + s / (z * z)


@distribution
class NoncentralChisq(UnivariateDistribution):
    """Noncentral chi-square(nu, lam) as a Poisson(lam/2) mixture of
    Chisq(nu + 2j); fixed-width logsumexp series."""
    nu: torch.Tensor = 1.0
    lam: torch.Tensor = 0.0

    def log_prob(self, x):
        nu, lam = _bc(self.nu, self.lam, like=x)
        j = _series_index(_SERIES_TERMS, x, x.dim())
        h = 0.5 * nu + j
        chisq_lp = (torch.xlogy(h - 1.0, x) - 0.5 * x - torch.lgamma(h)
                    - h * math.log(2.0))
        return torch.logsumexp(_pois_logpmf(j, 0.5 * lam) + chisq_lp, dim=0)

    def sample(self, gen, shape=()):
        nu, lam = _on(gen, self.nu, self.lam)
        j = _rpoisson(gen, shape, 0.5 * lam)
        return 2.0 * _rgamma(gen, (), 0.5 * nu + j)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def mean(self):
        nu, lam = _bc(self.nu, self.lam)
        return nu + lam


@distribution
class NoncentralBeta(UnivariateDistribution):
    """Type-I noncentral Beta(a, b, lam): Poisson(lam/2) mixture of
    Beta(a + j, b)."""
    alpha: torch.Tensor = 1.0
    beta: torch.Tensor = 1.0
    lam: torch.Tensor = 0.0

    def log_prob(self, x):
        a, b, lam = _bc(self.alpha, self.beta, self.lam, like=x)
        j = _series_index(_SERIES_TERMS, x, x.dim())
        aj = a + j
        beta_lp = (torch.xlogy(aj - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
                   - torch.lgamma(aj) - torch.lgamma(b) + torch.lgamma(aj + b))
        return torch.logsumexp(_pois_logpmf(j, 0.5 * lam) + beta_lp, dim=0)

    def sample(self, gen, shape=()):
        a, b, lam = _on(gen, self.alpha, self.beta, self.lam)
        j = _rpoisson(gen, shape, 0.5 * lam)
        g1 = _rgamma(gen, (), a + j)
        g2 = _rgamma(gen, shape, b)
        return g1 / (g1 + g2)

    def in_support(self, x):
        return _support(self, x, (x > 0) & (x < 1))

    def bijector(self):
        z = torch.zeros_like(_bc(self.alpha, self.beta, self.lam)[0])
        return bij.Sigmoid(z, z + 1.0)


@distribution
class NoncentralF(UnivariateDistribution):
    """Noncentral F(nu1, nu2, lam): Poisson mixture over the numerator."""
    nu1: torch.Tensor = 1.0
    nu2: torch.Tensor = 1.0
    lam: torch.Tensor = 0.0

    def log_prob(self, x):
        n1, n2, lam = _bc(self.nu1, self.nu2, self.lam, like=x)
        j = _series_index(_SERIES_TERMS, x, x.dim())
        h1, h2 = 0.5 * n1 + j, 0.5 * n2
        r = n1 / n2  # noncentral F keeps the *central* dof scaling
        z = r * x
        f_lp = (torch.log(r) + torch.xlogy(h1 - 1.0, z)
                - (h1 + h2) * torch.log1p(z)
                - torch.lgamma(h1) - torch.lgamma(h2) + torch.lgamma(h1 + h2))
        return torch.logsumexp(_pois_logpmf(j, 0.5 * lam) + f_lp, dim=0)

    def sample(self, gen, shape=()):
        n1, n2, lam = _on(gen, self.nu1, self.nu2, self.lam)
        j = _rpoisson(gen, shape, 0.5 * lam)
        num = 2.0 * _rgamma(gen, (), 0.5 * n1 + j)
        den = 2.0 * _rgamma(gen, shape, 0.5 * n2)
        return (num / n1) / (den / n2)

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()


@distribution
class NoncentralT(UnivariateDistribution):
    """Noncentral t(nu, lam) = (Z + lam)/sqrt(Chisq(nu)/nu).  Log-density by
    the signed series f(x) = c(x) sum_j Gamma((nu+j+1)/2)/j! (x lam sqrt2 /
    sqrt(nu+x^2))^j — terms alternate in sign for x*lam < 0, so the sum is
    accumulated with sign-tracked logsumexp."""
    nu: torch.Tensor = 1.0
    lam: torch.Tensor = 0.0

    def log_prob(self, x):
        nu, lam = _bc(self.nu, self.lam, like=x)
        j = _series_index(_SERIES_TERMS, x, max(x.dim(), nu.dim()))
        q = x * lam * torch.sqrt(2.0 / (nu + x * x))
        log_abs_q = torch.log(torch.clamp(torch.abs(q), min=1e-37))
        log_terms = (torch.lgamma(0.5 * (nu + j + 1.0)) - torch.lgamma(j + 1.0)
                     + j * log_abs_q)
        signs = torch.where((q < 0) & (j % 2 == 1), -1.0, 1.0).to(x.dtype)
        m = torch.amax(log_terms, dim=0, keepdim=True)
        s = torch.sum(signs * torch.exp(log_terms - m), dim=0)
        log_series = m.squeeze(0) + torch.log(torch.clamp(s, min=1e-37))
        log_c = (0.5 * torch.xlogy(nu, nu) - 0.5 * lam * lam
                 - 0.5 * math.log(math.pi) - torch.lgamma(0.5 * nu)
                 - 0.5 * (nu + 1.0) * torch.log(nu + x * x))
        return log_c + log_series

    def sample(self, gen, shape=()):
        nu, lam = _on(gen, self.nu, self.lam)
        z = _randn(gen, shape, lam)
        c = 2.0 * _rgamma(gen, shape, 0.5 * nu)
        return (z + lam) / torch.sqrt(c / nu)


def NormalCanon(eta=0.0, lam=1.0):
    """Canonical-form Normal: potential eta, precision lam
    (Distributions.jl NormalCanon) — mean eta/lam, sd 1/sqrt(lam)."""
    eta, lam = _bc(eta, lam)
    return Normal(mu=eta / lam, sigma=1.0 / torch.sqrt(lam))


@distribution
class Rayleigh(UnivariateDistribution):
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        (s,) = _bc(self.sigma, like=x)
        return torch.log(x) - 2.0 * torch.log(s) - 0.5 * (x / s) ** 2

    def sample(self, gen, shape=()):
        (s,) = _on(gen, self.sigma)
        return self.icdf(_rand(gen, shape, s))

    def in_support(self, x):
        return _support(self, x, x > 0)

    def bijector(self):
        return bij.Exp()

    def cdf(self, x):
        (s,) = _bc(self.sigma, like=x)
        return -torch.expm1(-0.5 * (x / s) ** 2)

    def icdf(self, q):
        (s,) = _bc(self.sigma, like=q)
        return s * torch.sqrt(-2.0 * torch.log1p(-q))

    def mean(self):
        (s,) = _bc(self.sigma)
        return s * math.sqrt(0.5 * math.pi)


@distribution
class TriangularDist(UnivariateDistribution):
    """Triangular on [a, b] with mode c."""
    a: torch.Tensor = 0.0
    b: torch.Tensor = 1.0
    c: torch.Tensor = 0.5

    def log_prob(self, x):
        a, b, c = _bc(self.a, self.b, self.c, like=x)
        up = math.log(2.0) + torch.log(x - a) - torch.log(b - a) - torch.log(c - a)
        down = math.log(2.0) + torch.log(b - x) - torch.log(b - a) - torch.log(b - c)
        at_c = math.log(2.0) - torch.log(b - a)
        return torch.where(x < c, up, torch.where(x > c, down, at_c))

    def cdf(self, x):
        a, b, c = _bc(self.a, self.b, self.c, like=x)
        x = torch.minimum(torch.maximum(x, a), b)
        lo = (x - a) ** 2 / ((b - a) * torch.clamp(c - a, min=1e-37))
        hi = 1.0 - (b - x) ** 2 / ((b - a) * torch.clamp(b - c, min=1e-37))
        return torch.where(x <= c, lo, hi)

    def icdf(self, q):
        a, b, c = _bc(self.a, self.b, self.c, like=q)
        fc = (c - a) / (b - a)
        lo = a + torch.sqrt(q * (b - a) * (c - a))
        hi = b - torch.sqrt((1.0 - q) * (b - a) * (b - c))
        return torch.where(q < fc, lo, hi)

    def sample(self, gen, shape=()):
        a, _, _ = _on(gen, self.a, self.b, self.c)
        return self.icdf(_rand(gen, shape, a))

    def in_support(self, x):
        a, b, _ = _bc(self.a, self.b, self.c, like=x)
        return (x >= a) & (x <= b)

    def bijector(self):
        a, b, _ = _bc(self.a, self.b, self.c)
        return bij.Sigmoid(a, b)

    def mean(self):
        a, b, c = _bc(self.a, self.b, self.c)
        return (a + b + c) / 3.0


def SymTriangularDist(mu=0.0, sigma=1.0):
    """Symmetric triangular on [mu - sigma, mu + sigma] (Distributions.jl)."""
    mu, sigma = _bc(mu, sigma)
    return TriangularDist(a=mu - sigma, b=mu + sigma, c=mu)


def _log_i0(x):
    """log I0(x) for x >= 0, via the exponentially-scaled Bessel i0e."""
    return torch.log(torch.special.i0e(x)) + x


@distribution
class VonMises(UnivariateDistribution):
    """Circular von Mises(mu, kappa) on [mu - pi, mu + pi].  Sampling is the
    Best-Fisher (1979) wrapped-Cauchy rejection, run as a fixed number of
    batched rounds (50 rounds => acceptance failure < 1e-30)."""
    mu: torch.Tensor = 0.0
    kappa: torch.Tensor = 1.0

    def log_prob(self, x):
        mu, k = _bc(self.mu, self.kappa, like=x)
        return k * torch.cos(x - mu) - math.log(2.0 * math.pi) - _log_i0(k)

    def sample(self, gen, shape=()):
        mu, kappa = _on(gen, self.mu, self.kappa)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
        r = (1.0 + rho * rho) / (2.0 * rho)
        theta = torch.zeros(tuple(shape) + tuple(mu.shape), dtype=mu.dtype,
                            device=gen.device)
        accepted = torch.zeros_like(theta, dtype=torch.bool)
        for _ in range(50):
            u1, u2, u3 = (_rand(gen, shape, mu) for _ in range(3))
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            ok = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
            th = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
            theta = torch.where(accepted, theta, torch.where(ok, th, theta))
            accepted = accepted | ok
        return mu + theta

    def in_support(self, x):
        mu = _bc(self.mu, self.kappa, like=x)[0]
        return (x >= mu - math.pi) & (x <= mu + math.pi)

    def bijector(self):
        mu = _bc(self.mu, self.kappa)[0]
        return bij.Sigmoid(mu - math.pi, mu + math.pi)

    def mean(self):
        return _bc(self.mu, self.kappa)[0]
