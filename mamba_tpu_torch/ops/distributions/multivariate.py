"""Multivariate and matrix-variate distributions (batched torch).

Replaces the reference's Distributions.jl multivariates and its PDMats2
block-diagonal extension (src/distributions/pdmats2.jl:16-148,
extensions.jl:18-33).  As in the JAX package:

- MvNormal comes in three forms (isotropic, diagonal, full Cholesky), so the
  common hierarchical cases never build a dense d x d matrix; the full form
  keeps a Cholesky factor, and ``log_prob`` is one triangular solve and a
  reduction.
- BDiagNormal holds its blocks batched as (n, b, b): ``log_prob`` is one
  batched triangular solve over the blocks.
- Wishart and InverseWishart are matrix-variate (``event_ndim = 2``), drawn
  by the Bartlett decomposition, with the ``CholeskyPD`` support bijector.

Factorizations inside a density go through ``_chol``: ``cholesky_ex``
without its error check (``torch.linalg.cholesky`` raises, and so waits for
the device, on a matrix that is not positive definite), with NaN where the
matrix is not positive definite, as ``jnp.linalg.cholesky`` gives.  Every
distribution's ``sample`` takes chain-stacked parameters (a leading chain
axis on each), as ``forward_sample`` hands them over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import bijectors as bij
from .. import random as R
from .base import (Distribution, _cast, _cast_on, _layout, _normal, _rgamma,
                   _shape, distribution)

__all__ = [
    "MvNormal", "MvNormalIso", "MvNormalDiag", "MvNormalFull", "MvNormalCanon",
    "MvTDist", "Dirichlet", "Multinomial", "BDiagNormal", "Wishart",
    "InverseWishart",
]

_LOG_2PI = 1.8378770664093453


def _chol(S):
    """Lower Cholesky factor of ``S (..., d, d)``; NaN where ``S`` is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _is_pd(x):
    """Positive definiteness of the symmetric matrices ``x (..., d, d)``
    (their lower triangles, as ``eigvalsh`` reads them)."""
    return torch.linalg.cholesky_ex(x).info == 0


def _tri_solve(L, B, upper=False):
    """``solve_triangular(L, B)`` with the batch dims of both broadcast."""
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    return torch.linalg.solve_triangular(
        L.expand(batch + L.shape[-2:]), B.expand(batch + B.shape[-2:]),
        upper=upper)


def _tri_solve_vec(L, v):
    """``solve_triangular`` for a vector right-hand side."""
    return _tri_solve(L, v[..., None])[..., 0]


def _matvec(A, v):
    return (A @ v[..., None])[..., 0]


def _logdiag(L):
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1))


class _MvBase(Distribution):
    event_ndim = 1


@distribution
class MvNormalIso(_MvBase):
    """N(mu, sigma^2 I); ``sigma`` is a standard deviation (may be batched)."""
    mu: torch.Tensor
    sigma: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.mu)[:-1], _shape(self.sigma))

    @property
    def event_shape(self):
        return _shape(self.mu)[-1:]

    def log_prob(self, x):
        mu, sigma = _cast(self.mu, self.sigma, like=x)
        d = mu.shape[-1]
        z = (x - mu) / sigma[..., None]
        return (-0.5 * torch.sum(z * z, -1) - d * torch.log(sigma)
                - 0.5 * d * _LOG_2PI)

    def sample(self, key, shape=()):
        mu, sigma = _cast_on(key, self.mu, self.sigma)
        return mu + sigma[..., None] * _normal(
            key, shape, self.batch_shape + self.event_shape, mu.dtype)

    def mean(self):
        mu, _ = _cast(self.mu, self.sigma)
        return mu.expand(self.batch_shape + self.event_shape)

    def cov(self):
        _, s = _cast(self.mu, self.sigma)
        eye = torch.eye(self.event_shape[0], dtype=s.dtype, device=s.device)
        return (s * s)[..., None, None] * eye

    def invcov(self):
        _, s = _cast(self.mu, self.sigma)
        eye = torch.eye(self.event_shape[0], dtype=s.dtype, device=s.device)
        return eye / (s * s)[..., None, None]


@distribution
class MvNormalDiag(_MvBase):
    """N(mu, diag(sigma^2)); ``sigma`` is the vector of standard deviations."""
    mu: torch.Tensor
    sigma: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.mu)[:-1],
                                      _shape(self.sigma)[:-1])

    @property
    def event_shape(self):
        return _shape(self.mu)[-1:]

    def log_prob(self, x):
        mu, sigma = _cast(self.mu, self.sigma, like=x)
        z = (x - mu) / sigma
        d = z.shape[-1]
        return (-0.5 * torch.sum(z * z, -1) - torch.sum(torch.log(sigma), -1)
                - 0.5 * d * _LOG_2PI)

    def sample(self, key, shape=()):
        mu, sigma = _cast_on(key, self.mu, self.sigma)
        return mu + sigma * _normal(
            key, shape, self.batch_shape + self.event_shape, mu.dtype)

    def mean(self):
        mu, _ = _cast(self.mu, self.sigma)
        return mu.expand(self.batch_shape + self.event_shape)

    def cov(self):
        return torch.diag_embed(_cast(self.mu, self.sigma)[1] ** 2)

    def invcov(self):
        return torch.diag_embed(1.0 / _cast(self.mu, self.sigma)[1] ** 2)


@distribution
class MvNormalFull(_MvBase):
    """N(mu, L L^T) with lower-Cholesky ``scale_tril``."""
    mu: torch.Tensor
    scale_tril: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.mu)[:-1],
                                      _shape(self.scale_tril)[:-2])

    @property
    def event_shape(self):
        return _shape(self.scale_tril)[-1:]

    def log_prob(self, x):
        mu, L = _cast(self.mu, self.scale_tril, like=x)
        d = L.shape[-1]
        z = _tri_solve_vec(L, x - mu)
        return (-0.5 * torch.sum(z * z, -1) - torch.sum(_logdiag(L), -1)
                - 0.5 * d * _LOG_2PI)

    def sample(self, key, shape=()):
        mu, L = _cast_on(key, self.mu, self.scale_tril)
        eps = _normal(key, shape, self.batch_shape + self.event_shape, L.dtype)
        return mu + _matvec(L, eps)

    def mean(self):
        mu, _ = _cast(self.mu, self.scale_tril)
        return mu.expand(self.batch_shape + self.event_shape)

    def cov(self):
        L = _cast(self.scale_tril)[0]
        return L @ L.transpose(-1, -2)

    def invcov(self):
        L = _cast(self.scale_tril)[0]
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return Linv.transpose(-1, -2) @ Linv


def _as_tensor(v):
    """A parameter as a tensor: numpy arrays keep their dtype, Python
    numbers take the default one, by a fill on the device (a copy from the
    host would wait for it, and a CUDA graph cannot capture it: ABC's
    captured batches evaluate priors such as ``MvNormal(mu, 10.0)``)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v)
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=torch.get_default_dtype())
    return torch.as_tensor(v, dtype=torch.get_default_dtype())


def MvNormal(*args, mu=None, cov=None, scale_tril=None, sigma=None):
    """Factory for the reference's Distributions.jl call forms
    (src/distributions/constructors.jl:39-57):

    - ``MvNormal(mu, s)`` with scalar ``s``  -> isotropic, std ``s``
    - ``MvNormal(mu, v)`` with vector ``v``  -> diagonal, stds ``v``
    - ``MvNormal(mu, S)`` with matrix ``S``  -> full covariance ``S``
    - ``MvNormal(d::int, s)``                -> zero-mean isotropic
    - ``MvNormal(S)`` with matrix            -> zero-mean full covariance

    The keyword forms take a precomputed ``scale_tril``."""
    if args:
        if len(args) == 1:
            S = _as_tensor(args[0])
            return MvNormalFull(torch.zeros(S.shape[-1], dtype=S.dtype,
                                            device=S.device), _chol(S))
        m, s = args
        if isinstance(m, (int, np.integer)):
            m = torch.zeros(m)
        m, s = _as_tensor(m), _as_tensor(s)
        if s.dim() == m.dim() - 1 or s.dim() == 0:
            return MvNormalIso(m, s)
        if s.shape == m.shape:
            return MvNormalDiag(m, s)
        if s.dim() >= 2 and s.shape[-1] == s.shape[-2] == m.shape[-1]:
            # a shared (or batched) covariance matrix with batched means
            return MvNormalFull(m, _chol(s))
        if s.dim() == m.dim():
            return MvNormalDiag(m, s)
        return MvNormalFull(m, _chol(s))
    if scale_tril is not None:
        return MvNormalFull(_as_tensor(mu), _as_tensor(scale_tril))
    if cov is not None:
        c = _as_tensor(cov)
        if mu is None:
            mu = torch.zeros(c.shape[-1], dtype=c.dtype, device=c.device)
        return MvNormalFull(_as_tensor(mu), _chol(c))
    if sigma is not None:
        s, m = _as_tensor(sigma), _as_tensor(mu)
        return MvNormalIso(m, s) if s.dim() < m.dim() else MvNormalDiag(m, s)
    raise TypeError("MvNormal: no parameterization given")


def _solve(A, b):
    """``A^-1 b`` for a vector ``b``, without the error check that waits for
    the device."""
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-1])
    return torch.linalg.solve_ex(A.expand(batch + A.shape[-2:]),
                                 b.expand(batch + b.shape[-1:])[..., None]
                                 ).result[..., 0]


@distribution
class MvNormalCanon(_MvBase):
    """Canonical (natural-parameter) MvNormal: potential ``h``, precision
    ``J`` (reference constructors.jl:47-50); x ~ N(J^-1 h, J^-1)."""
    h: torch.Tensor
    J: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.h)[:-1], _shape(self.J)[:-2])

    @property
    def event_shape(self):
        return _shape(self.J)[-1:]

    def log_prob(self, x):
        h, J = _cast(self.h, self.J, like=x)
        d = J.shape[-1]
        # J^-1 h through J's factor: a J off the cone gives NaN, where the
        # gradient of a general solve would raise
        L = _chol(J)
        mu = _tri_solve(L.transpose(-1, -2), _tri_solve_vec(L, h)[..., None],
                        upper=True)[..., 0]
        diff = x - mu
        q = torch.sum(diff * _matvec(J, diff), -1)
        return -0.5 * q + torch.sum(_logdiag(L), -1) - 0.5 * d * _LOG_2PI

    def sample(self, key, shape=()):
        h, J = _cast_on(key, self.h, self.J)
        eps = _normal(key, shape, self.batch_shape + self.event_shape, J.dtype)
        # x = mu + Lp^-T eps has covariance J^-1
        z = _tri_solve(_chol(J).transpose(-1, -2), eps[..., None], upper=True)
        return _solve(J, h) + z[..., 0]

    def mean(self):
        return _solve(*_cast(self.J, self.h))

    def invcov(self):
        return _cast(self.J)[0]


@distribution
class MvTDist(_MvBase):
    """Multivariate Student-t with ``nu`` degrees of freedom, location ``mu``
    and scale matrix ``Sigma`` (reference constructors.jl:59-66)."""
    nu: torch.Tensor
    mu: torch.Tensor
    Sigma: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.nu), _shape(self.mu)[:-1],
                                      _shape(self.Sigma)[:-2])

    @property
    def event_shape(self):
        return _shape(self.Sigma)[-1:]

    def log_prob(self, x):
        nu, mu, S = _cast(self.nu, self.mu, self.Sigma, like=x)
        L = _chol(S)
        d = L.shape[-1]
        z = _tri_solve_vec(L, x - mu)
        q = torch.sum(z * z, -1)
        return (torch.lgamma(0.5 * (nu + d)) - torch.lgamma(0.5 * nu)
                - 0.5 * d * torch.log(nu * math.pi)
                - torch.sum(_logdiag(L), -1)
                - 0.5 * (nu + d) * torch.log1p(q / nu))

    def sample(self, key, shape=()):
        nu, mu, S = _cast_on(key, self.nu, self.mu, self.Sigma)
        L = _chol(S)
        batch = tuple(self.batch_shape)
        kn, kg = R.split(key)
        eps = _normal(kn, shape, batch + tuple(self.event_shape), L.dtype)
        g = _rgamma(kg, shape, (0.5 * nu).expand(batch))
        w = torch.sqrt(0.5 * nu / g)
        return mu + w[..., None] * _matvec(L, eps)

    def mean(self):
        _, mu, _ = _cast(self.nu, self.mu, self.Sigma)
        return mu.expand(self.batch_shape + self.event_shape)


@distribution
class Dirichlet(_MvBase):
    alpha: torch.Tensor

    def log_prob(self, x):
        (a,) = _cast(self.alpha, like=x)
        return (torch.sum(torch.xlogy(a - 1.0, x), -1)
                - torch.sum(torch.lgamma(a), -1) + torch.lgamma(torch.sum(a, -1)))

    def sample(self, key, shape=()):
        (a,) = _cast_on(key, self.alpha)
        g = _rgamma(key, shape, a)
        return g / torch.sum(g, -1, keepdim=True)

    def in_support(self, x):
        return (torch.all(x > 0, -1) & torch.all(x < 1, -1)
                & (torch.abs(torch.sum(x, -1) - 1.0) < 1e-5))

    def bijector(self):
        return bij.StickBreaking()

    def mean(self):
        (a,) = _cast(self.alpha)
        return a / torch.sum(a, -1, keepdim=True)


@distribution
class Multinomial(_MvBase):
    """``n`` trials over the categories of the probability vector ``p``."""
    n: torch.Tensor
    p: torch.Tensor

    is_discrete = True

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.n), _shape(self.p)[:-1])

    @property
    def event_shape(self):
        return _shape(self.p)[-1:]

    def log_prob(self, x):
        n, p = _cast(self.n, self.p, like=x)
        return (torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), -1)
                + torch.sum(torch.xlogy(x, p), -1))

    def sample(self, key, shape=()):
        # a binomial draw per category, conditioned on the ones before it
        n, p = _cast_on(key, self.n, self.p)
        batch = tuple(self.batch_shape)
        full = tuple(shape) + batch
        K = p.shape[-1]
        p = p.expand(full + (K,))
        left = n.expand(full)
        mass = torch.ones_like(left)
        out = []
        _, front, back = _layout(key, shape, batch)
        for k, kk in zip(range(K - 1), R.split(key, max(K - 1, 1))):
            q = torch.clamp(torch.nan_to_num(p[..., k] / mass), 0.0, 1.0)
            xk = back(R.binomial(kk, front(left), front(q)))
            out.append(xk)
            left = left - xk
            mass = mass - p[..., k]
        out.append(left)
        return torch.stack(out, -1)

    def in_support(self, x):
        n, _ = _cast(self.n, self.p, like=x)
        return torch.all(x >= 0, -1) & (torch.abs(torch.sum(x, -1) - n) < 1e-6)

    def bijector(self):
        return bij.Discrete()

    def mean(self):
        n, p = _cast(self.n, self.p)
        return n[..., None] * p


@distribution
class BDiagNormal(_MvBase):
    """Block-diagonal MvNormal: mean ``mu (..., n*b)`` and covariance blocks
    ``blocks (..., n, b, b)`` (reference extensions.jl:18-33 and
    pdmats2.jl): one batched Cholesky and triangular solve over the blocks
    instead of the reference's per-block loop.  Unlike the JAX class it
    keeps a leading batch (the chain axis, in ``forward_sample``)."""
    mu: torch.Tensor
    blocks: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.mu)[:-1],
                                      _shape(self.blocks)[:-3])

    @property
    def event_shape(self):
        return _shape(self.mu)[-1:]

    def log_prob(self, x):
        mu, blocks = _cast(self.mu, self.blocks, like=x)
        Ls = _chol(blocks)
        n, b = Ls.shape[-3], Ls.shape[-1]
        diff = x - mu
        z = _tri_solve_vec(Ls, diff.reshape(diff.shape[:-1] + (n, b)))
        return (-0.5 * torch.sum(z * z, (-2, -1))
                - torch.sum(_logdiag(Ls), (-2, -1)) - 0.5 * n * b * _LOG_2PI)

    def sample(self, key, shape=()):
        mu, blocks = _cast_on(key, self.mu, self.blocks)
        Ls = _chol(blocks)
        n, b = Ls.shape[-3], Ls.shape[-1]
        lead = tuple(shape) + tuple(self.batch_shape)
        eps = _normal(key, shape, tuple(self.batch_shape) + (n, b), mu.dtype)
        return mu + _matvec(Ls, eps).reshape(lead + (n * b,))

    def mean(self):
        mu, _ = _cast(self.mu, self.blocks)
        return mu.expand(self.batch_shape + self.event_shape)


def _lmvgamma(d, a):
    """log multivariate gamma."""
    i = torch.arange(1, d + 1, dtype=a.dtype, device=a.device)
    return (0.25 * d * (d - 1) * math.log(math.pi)
            + torch.sum(torch.lgamma(a[..., None] + 0.5 * (1.0 - i)), -1))


def _trace(A):
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


class _MatrixBase(Distribution):
    event_ndim = 2


@distribution
class Wishart(_MatrixBase):
    """Wishart(nu, S): E[X] = nu * S (reference constructors.jl:90-97,
    pdmatdistribution.jl)."""
    nu: torch.Tensor
    S: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.nu), _shape(self.S)[:-2])

    @property
    def event_shape(self):
        return _shape(self.S)[-2:]

    def log_prob(self, x):
        nu, S = _cast(self.nu, self.S, like=x)
        d = S.shape[-1]
        Ls, Lx = _chol(S), _chol(x)
        logdet_x = 2.0 * torch.sum(_logdiag(Lx), -1)
        logdet_s = 2.0 * torch.sum(_logdiag(Ls), -1)
        # tr(S^-1 x)
        A = _tri_solve(Ls, x)
        A = _tri_solve(Ls, A.transpose(-1, -2))
        return (0.5 * (nu - d - 1.0) * logdet_x - 0.5 * _trace(A)
                - 0.5 * nu * d * math.log(2.0) - 0.5 * nu * logdet_s
                - _lmvgamma(d, 0.5 * nu))

    def sample(self, key, shape=()):
        nu, S = _cast_on(key, self.nu, self.S)
        d = S.shape[-1]
        Ls = _chol(S)
        batch = tuple(self.batch_shape)
        # Bartlett: A lower triangular, A_ii ~ sqrt(chi2(nu - i + 1)), the
        # entries below the diagonal N(0, 1)
        kn, kg = R.split(key)
        zn = _normal(kn, shape, batch + (d, d), S.dtype)
        i = torch.arange(d, dtype=S.dtype, device=key.device)
        chi = 2.0 * _rgamma(kg, shape, (0.5 * (nu[..., None] - i)).expand(batch + (d,)))
        A = torch.tril(zn, -1) + torch.diag_embed(torch.sqrt(chi))
        LA = Ls @ A
        return LA @ LA.transpose(-1, -2)

    def in_support(self, x):
        return _is_pd(x)

    def bijector(self):
        return bij.CholeskyPD(int(_shape(self.S)[-1]))

    def mean(self):
        nu, S = _cast(self.nu, self.S)
        return nu[..., None, None] * S


@distribution
class InverseWishart(_MatrixBase):
    """InverseWishart(nu, Psi): E[X] = Psi / (nu - d - 1)."""
    nu: torch.Tensor
    Psi: torch.Tensor

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.nu), _shape(self.Psi)[:-2])

    @property
    def event_shape(self):
        return _shape(self.Psi)[-2:]

    def log_prob(self, x):
        nu, Psi = _cast(self.nu, self.Psi, like=x)
        d = Psi.shape[-1]
        Lp, Lx = _chol(Psi), _chol(x)
        logdet_x = 2.0 * torch.sum(_logdiag(Lx), -1)
        logdet_p = 2.0 * torch.sum(_logdiag(Lp), -1)
        # tr(Psi x^-1) by solves against Lx
        A = _tri_solve(Lx, Psi)
        A = _tri_solve(Lx, A.transpose(-1, -2))
        return (0.5 * nu * logdet_p - 0.5 * (nu + d + 1.0) * logdet_x
                - 0.5 * _trace(A) - 0.5 * nu * d * math.log(2.0)
                - _lmvgamma(d, 0.5 * nu))

    def sample(self, key, shape=()):
        nu, Psi = _cast_on(key, self.nu, self.Psi)
        W = Wishart(nu, torch.linalg.inv_ex(Psi).inverse)
        return torch.linalg.inv_ex(W.sample(key, shape)).inverse

    def in_support(self, x):
        return _is_pd(x)

    def bijector(self):
        return bij.CholeskyPD(int(_shape(self.Psi)[-1]))

    def mean(self):
        nu, Psi = _cast(self.nu, self.Psi)
        return Psi / (nu[..., None, None] - Psi.shape[-1] - 1.0)
