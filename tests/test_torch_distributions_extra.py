"""The port's remaining univariate and discrete distributions
(``univariate_extra``, ``discrete_extra``) against the JAX package's, one
parametrised case per class or factory, with the harness and the tolerances
of ``test_torch_distributions.py``: rtol 1e-10, and 1e-8 (``RTOL_SERIES``)
where the port's own ``betainc``, a bisection or the two libraries'
incomplete gamma functions are on the path.

The JAX package's series for the noncentral laws and Skellam index their
terms with a float32 ``arange``, so ``gammaln(j + 1)`` and the Poisson
weights are rounded to float32 even under x64: its values carry a relative
error of about 1e-7.  Those classes are held to the JAX package at rtol
and atol 2e-6 (``RTOL_F32_SERIES``) and, so that the port is not held to that error,
to scipy's noncentral and Skellam laws at 1e-9.  Its ``Kolmogorov.mean`` is
a float32 constant (rtol 1e-7 there), and the gradient of its
``KSOneSided.log_prob`` in ``x`` is NaN (a second derivative through its
masks), so the port's is checked against a central difference instead."""

import math

import numpy as np
import pytest
import torch

from scipy import stats

import mamba_tpu_torch.ops.distributions as td
from mamba_tpu_torch.ops import random as R
from test_torch_distributions import (N, RTOL_SERIES, Case, U, _pos, _real,
                                      _unit, check_density, check_sampling)

torch.set_num_threads(2)

RTOL_F32_SERIES = 2e-6


def _kernel(name):
    return Case(name, dict(mu=U(-2, 2), sigma=U(0.5, 2)),
                lambda rng, p: p["mu"] + p["sigma"] * rng.uniform(-0.9, 0.9, N),
                out=lambda rng, p: p["mu"] + 1.5 * p["sigma"])


def _static_n(name, n, **kw):
    return Case(name, dict(n=lambda rng: n),
                lambda rng, p: rng.uniform(0.05, 0.6, N),
                out=lambda rng, p: np.full(N, 1.5), diff=(), **kw)


EXTRA = [
    Case("Arcsine", dict(a=U(-2, 0), b=U(0.5, 3)),
         lambda rng, p: p["a"] + (p["b"] - p["a"]) * rng.uniform(0.05, 0.95, N),
         out=lambda rng, p: p["b"] + rng.uniform(0.1, 1, N)),
    Case("BetaPrime", dict(alpha=U(0.8, 4), beta=U(1.5, 5)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), rtol=RTOL_SERIES),
    _kernel("Biweight"),
    Case("Chi", dict(nu=U(1, 8)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), rtol=RTOL_SERIES),
    _kernel("Cosine"),
    _kernel("Epanechnikov"),
    Case("Erlang", dict(alpha=lambda rng: rng.integers(1, 6, N).astype(float),
                        theta=U(0.3, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), diff=("theta",),
         rtol=RTOL_SERIES),
    Case("FDist", dict(nu1=U(2, 9), nu2=U(4.5, 12)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), rtol=RTOL_SERIES),
    Case("Frechet", dict(alpha=U(1, 4), theta=U(0.5, 2)), _pos(0.2, 4.0),
         out=lambda rng, p: -rng.uniform(0.1, 1, N)),
    Case("InverseGaussian", dict(mu=U(0.5, 3), lam=U(0.5, 4)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N)),
    Case("Kolmogorov", dict(), lambda rng, p: rng.uniform(0.4, 2.0, N),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), moment_rtol=1e-7),
    _static_n("KSDist", 25),
    _static_n("KSOneSided", 12, grad_x=False),
    Case("Levy", dict(mu=U(-1, 1), sigma=U(0.5, 2)),
         lambda rng, p: p["mu"] + rng.uniform(0.1, 5, N),
         out=lambda rng, p: p["mu"] - rng.uniform(0.1, 1, N)),
    Case("NoncentralBeta", dict(alpha=U(0.8, 4), beta=U(0.8, 4), lam=U(0.1, 6)),
         _unit, out=lambda rng, p: 1.0 + rng.uniform(0.1, 1, N),
         rtol=RTOL_F32_SERIES, atol=RTOL_F32_SERIES),
    Case("NoncentralChisq", dict(nu=U(1, 8), lam=U(0.1, 8)), _pos(0.1, 12.0),
         out=lambda rng, p: -rng.uniform(0.1, 1, N), rtol=RTOL_F32_SERIES, atol=RTOL_F32_SERIES),
    Case("NoncentralF", dict(nu1=U(2, 9), nu2=U(4.5, 12), lam=U(0.1, 6)),
         _pos(), out=lambda rng, p: -rng.uniform(0.1, 1, N),
         rtol=RTOL_F32_SERIES, atol=RTOL_F32_SERIES),
    Case("NoncentralT", dict(nu=U(2, 9), lam=U(-1.5, 1.5)), _real(1.5),
         rtol=RTOL_F32_SERIES, atol=RTOL_F32_SERIES),
    Case("NormalCanon", dict(eta=U(-2, 2), lam=U(0.3, 3)), _real()),
    Case("Rayleigh", dict(sigma=U(0.5, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 1, N)),
    Case("SymTriangularDist", dict(mu=U(-2, 2), sigma=U(0.5, 2)),
         lambda rng, p: p["mu"] + p["sigma"] * rng.uniform(-0.9, 0.9, N),
         out=lambda rng, p: p["mu"] + 1.5 * p["sigma"]),
    Case("TriangularDist", dict(a=U(-2, -1), b=U(1, 3), c=U(-0.5, 0.5)),
         lambda rng, p: p["a"] + (p["b"] - p["a"]) * rng.uniform(0.05, 0.95, N),
         out=lambda rng, p: p["b"] + rng.uniform(0.1, 1, N)),
    _kernel("Triweight"),
    Case("VonMises", dict(mu=U(-1, 1), kappa=U(0.3, 4)),
         lambda rng, p: p["mu"] + rng.uniform(-3, 3, N),
         out=lambda rng, p: p["mu"] + 4.0),
]
DISCRETE_EXTRA = [
    Case("PoissonBinomial", dict(p=lambda rng: rng.uniform(0.1, 0.9, (N, 7))),
         lambda rng, p: rng.integers(0, 8, N).astype(float),
         out=lambda rng, p: np.full(N, 8.0), discrete=True),
    Case("Skellam", dict(mu1=U(0.5, 6), mu2=U(0.5, 6)),
         lambda rng, p: rng.integers(-6, 7, N).astype(float),
         out=lambda rng, p: np.full(N, 0.5), discrete=True,
         rtol=RTOL_F32_SERIES, atol=RTOL_F32_SERIES),
    Case("NoncentralHypergeometric",
         dict(ns=lambda rng: rng.integers(5, 12, N).astype(float),
              nf=lambda rng: rng.integers(3, 10, N).astype(float),
              n=lambda rng: rng.integers(4, 8, N).astype(float),
              omega=U(0.4, 3)),
         lambda rng, p: np.floor(np.maximum(0, p["n"] - p["nf"]) + (
             np.minimum(p["ns"], p["n"]) - np.maximum(0, p["n"] - p["nf"]) + 1)
             * rng.uniform(0, 0.999, N)),
         out=lambda rng, p: np.minimum(p["ns"], p["n"]) + 1.0,
         diff=("omega",), discrete=True),
]


@pytest.mark.parametrize("case", EXTRA + DISCRETE_EXTRA, ids=lambda c: c.name)
def test_density_parity(case):
    check_density(case)


@pytest.mark.parametrize("case", EXTRA + DISCRETE_EXTRA, ids=lambda c: c.name)
def test_sampling_in_distribution(case):
    check_sampling(case)


def test_noncentral_hypergeometric_static_width():
    import mamba_tpu_torch.ops.distributions as td
    a = td.NoncentralHypergeometric(8.0, 6.0, 5.0, 1.7)
    b = td.NoncentralHypergeometric(8.0, 6.0, 5.0, 1.7, max_support=9)
    x = torch.arange(0.0, 6.0, dtype=torch.float64)
    np.testing.assert_allclose(a.log_prob(x).numpy(), b.log_prob(x).numpy(),
                               rtol=1e-12)
    assert abs(float(torch.exp(a.log_prob(x)).sum()) - 1.0) < 1e-12
    assert math.isclose(float(a.mean()), float(
        (x * torch.exp(a.log_prob(x))).sum()), rel_tol=1e-6)


def test_series_laws_against_scipy():
    # the port's float64 series, independent of the JAX package's float32 one
    rng = np.random.default_rng(7)
    nu, nu2, lam = rng.uniform(1, 8, N), rng.uniform(4.5, 12, N), rng.uniform(0.1, 6, N)
    x = rng.uniform(0.1, 6, N)
    t = lambda v: torch.as_tensor(v)       # noqa: E731
    np.testing.assert_allclose(
        td.NoncentralChisq(t(nu), t(lam)).log_prob(t(x)).numpy(),
        stats.ncx2.logpdf(x, nu, lam), rtol=1e-9)
    np.testing.assert_allclose(
        td.NoncentralF(t(nu), t(nu2), t(lam)).log_prob(t(x)).numpy(),
        stats.ncf.logpdf(x, nu, nu2, lam), rtol=1e-9)
    z, delta = rng.normal(0, 1.5, N), rng.uniform(-1.5, 1.5, N)
    np.testing.assert_allclose(
        td.NoncentralT(t(nu + 1), t(delta)).log_prob(t(z)).numpy(),
        stats.nct.logpdf(z, nu + 1, delta), rtol=1e-9)
    k = rng.integers(-6, 7, N).astype(float)
    np.testing.assert_allclose(
        td.Skellam(t(nu), t(lam)).log_prob(t(k)).numpy(),
        stats.skellam.logpmf(k, nu, lam), rtol=1e-9)


def test_ks_one_sided_gradient_against_a_central_difference():
    d = td.KSOneSided(12)
    x = torch.tensor([0.05, 0.1, 0.2, 0.3, 0.45, 0.6], dtype=torch.float64)
    g = torch.func.grad(lambda v: d.log_prob(v).sum())(x)
    h = 1e-6
    fd = (d.log_prob(x + h) - d.log_prob(x - h)) / (2 * h)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-6)
    # and the density integrates to the cdf (it has kinks at j / n, so the
    # trapezoid rule is held to 1e-4)
    grid = torch.linspace(1e-6, 0.6, 20001, dtype=torch.float64)
    area = torch.trapezoid(torch.exp(d.log_prob(grid)), grid)
    assert abs(float(area) - float(d.cdf(grid[-1]) - d.cdf(grid[0]))) < 1e-4
