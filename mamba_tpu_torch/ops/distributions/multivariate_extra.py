"""Von Mises-Fisher directional distribution (reference import list,
src/Mamba.jl:31-33).

It needs log I_v(kappa) for a real order v = p/2 - 1: ``log_bessel_i``, an
ascending power series for small arguments switched (by ``torch.where``,
branch-free) to the large-argument asymptotic expansion.  Its series runs
to as many terms as its range needs, where the JAX package's stops at 48.  Sampling is
Wood's (1994) rejection for the cosine to the mean direction, run as 64
fixed rounds over the whole batch (the first accepted round wins), composed
with a uniform tangent direction and a Householder reflection onto the mean
direction.
"""

from __future__ import annotations

import math

import torch

from .base import _cast, _cast_on, _rgamma, _shape, distribution
from .multivariate import _MvBase

__all__ = ["VonMisesFisher", "log_bessel_i"]

_SERIES_K = 48
#: rejection rounds of Wood's sampler
_ROUNDS = 64


def _float(*vals):
    """Tensors in the dtype the values promote to, at least float32."""
    dtype = torch.float32
    for v in vals:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            dtype = torch.promote_types(dtype, v.dtype)
    return _cast(*vals, like=torch.zeros((), dtype=dtype, device=next(
        (v.device for v in vals if isinstance(v, torch.Tensor)), None)))


def _series_terms(v):
    """Terms of the series that reach its switch point z = 30 + v^2 to
    rounding: its largest term is near k = z / 2, and the terms fall off
    within about 6 sqrt(z) past it."""
    vmax = float(torch.max(v)) if isinstance(v, torch.Tensor) else float(v)
    switch = 30.0 + vmax * vmax
    return max(_SERIES_K, int(math.ceil(0.5 * switch + 6.0 * math.sqrt(switch))))


def log_bessel_i(v, z):
    """log I_v(z) for v >= 0, z > 0, elementwise.

    Small z: logsumexp of the ascending series
        I_v(z) = sum_k (z/2)^(v+2k) / (k! Gamma(v+k+1)).
    Large z (> 30 + v^2): the asymptotic form
        I_v(z) ~ e^z / sqrt(2 pi z) * (1 - (mu-1)/(8z) + ...),  mu = 4 v^2.

    The JAX package caps the series' argument at 60 + v^2 / 2 and cuts it
    at 48 terms, which is exact only below z = 60; here the series has as
    many terms as its range needs (``v`` is read on the host for that)."""
    K = _series_terms(v)
    v, z = torch.broadcast_tensors(*_float(v, z))

    # series branch (past the switch its value is not used)
    zs = torch.minimum(z, 30.0 + v * v)
    k = torch.arange(K, dtype=z.dtype, device=z.device).reshape(
        (-1,) + (1,) * z.dim())
    terms = ((v + 2.0 * k) * torch.log(0.5 * zs) - torch.lgamma(k + 1.0)
             - torch.lgamma(v + k + 1.0))
    series = torch.logsumexp(terms, dim=0)

    # asymptotic branch
    mu = 4.0 * v * v
    za = torch.clamp(z, min=1.0)
    corr = (1.0 - (mu - 1.0) / (8.0 * za)
            + (mu - 1.0) * (mu - 9.0) / (128.0 * za * za)
            - (mu - 1.0) * (mu - 9.0) * (mu - 25.0) / (3072.0 * za ** 3))
    asym = (z - 0.5 * torch.log(2.0 * math.pi * za)
            + torch.log(torch.clamp(corr, min=1e-30)))
    return torch.where(z < 30.0 + 0.25 * mu, series, asym)


@distribution
class VonMisesFisher(_MvBase):
    """vMF on the unit sphere S^(p-1): density C_p(kappa) exp(kappa mu.x)
    with C_p(kappa) = kappa^(p/2-1) / ((2 pi)^(p/2) I_(p/2-1)(kappa)).
    ``mu`` must be unit-norm."""
    mu: torch.Tensor
    kappa: torch.Tensor = 1.0

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(_shape(self.mu)[:-1], _shape(self.kappa))

    @property
    def event_shape(self):
        return _shape(self.mu)[-1:]

    def _log_norm(self, kappa):
        p = _shape(self.mu)[-1]
        v = 0.5 * p - 1.0
        kappa = torch.clamp(kappa, min=1e-30)
        return (v * torch.log(kappa) - 0.5 * p * math.log(2.0 * math.pi)
                - log_bessel_i(v, kappa))

    def log_prob(self, x):
        mu, kappa = _cast(self.mu, self.kappa, like=x)
        return kappa * torch.sum(mu * x, -1) + self._log_norm(kappa)

    def in_support(self, x):
        return torch.abs(torch.sum(x * x, -1) - 1.0) < 1e-3

    def sample(self, gen, shape=()):
        mu, kappa = _cast_on(gen, self.mu, self.kappa)
        p = mu.shape[-1]
        out = tuple(shape) + tuple(self.batch_shape)
        kappa = kappa.expand(out)
        f = dict(dtype=mu.dtype, device=gen.device)

        # Wood (1994): rejection for w = cos(angle to mu)
        d = p - 1.0
        b = d / (2.0 * kappa + torch.sqrt(4.0 * kappa * kappa + d * d))
        x0 = (1.0 - b) / (1.0 + b)
        c = kappa * x0 + d * torch.log(1.0 - x0 * x0)
        half = torch.full((_ROUNDS,) + out, 0.5 * d, **f)
        g1, g2 = _rgamma(gen, (), half), _rgamma(gen, (), half)
        zb = g1 / (g1 + g2)                               # Beta(d/2, d/2)
        u = 1e-7 + (1.0 - 1e-7) * torch.rand((_ROUNDS,) + out, generator=gen, **f)
        wc = (1.0 - (1.0 + b) * zb) / (1.0 - (1.0 - b) * zb)
        ok = (kappa * wc + d * torch.log(torch.clamp(1.0 - x0 * wc, min=1e-30))
              - c >= torch.log(u))
        first = torch.argmax(ok.to(torch.int8), dim=0)
        w = torch.where(ok.any(0), torch.gather(wc, 0, first[None])[0],
                        torch.full_like(kappa, 1.0 - 1e-6))

        # a uniform direction in the tangent (p-1)-subspace of e1
        v = torch.randn(out + (p - 1,), generator=gen, **f)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        z = torch.cat([w[..., None],
                       torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))[..., None] * v],
                      dim=-1)

        # Householder: reflect e1 onto mu
        e1 = torch.zeros(p, **f)
        e1[0] = 1.0
        uh = e1 - mu
        norm = torch.linalg.vector_norm(uh, dim=-1, keepdim=True)
        uh = torch.where(norm > 1e-7, uh / torch.clamp(norm, min=1e-30),
                         torch.zeros_like(uh))
        return z - 2.0 * torch.sum(z * uh, -1, keepdim=True) * uh

    def mean(self):
        # the mean direction scaled by A_p(kappa) = I_{p/2} / I_{p/2-1}
        mu, kappa = _cast(self.mu, self.kappa)
        p = mu.shape[-1]
        kappa = torch.clamp(kappa, min=1e-30)
        a = torch.exp(log_bessel_i(0.5 * p, kappa)
                      - log_bessel_i(0.5 * p - 1.0, kappa))
        return mu * a[..., None]
