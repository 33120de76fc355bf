"""Adaptive Mixture Metropolis, batched over chains (reference
src/samplers/amm.jl).

Haario-style adaptive Metropolis: beta-mixture of a fixed proposal and a
running empirical-covariance proposal, each chain with its own moments and
factor.  The reference guards rank deficiency with a pivoted Cholesky
(amm.jl:87-89); here ``torch.linalg.cholesky_ex`` factors every chain's
empirical covariance at once and reports per chain whether it was positive
definite, and a chain whose covariance was not keeps its previous factor.

Random draws per step, in order: the fixed proposal's normals ``(C, dim)``,
the adaptive proposal's normals ``(C, dim)``, the acceptance uniforms
``(C,)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import SamplerSpec, metropolis_accept


class AMMTune(NamedTuple):
    SigmaL: torch.Tensor    # (C, dim, dim) fixed proposal Cholesky
    SigmaLm: torch.Tensor   # (C, dim, dim) adaptive (empirical) proposal Cholesky
    Mv: torch.Tensor        # (C, dim) running mean
    Mvv: torch.Tensor       # (C, dim, dim) running second moment
    m: torch.Tensor         # (C,) int32 adaptation steps so far
    beta: float
    scale: float


def amm_init(x0, Sigma, beta: float = 0.05, scale: float = 2.38) -> AMMTune:
    C, n = x0.shape
    SigmaL = torch.linalg.cholesky(
        torch.as_tensor(Sigma, dtype=x0.dtype, device=x0.device))
    return AMMTune(SigmaL=SigmaL.expand(C, n, n).clone(),
                   SigmaLm=torch.zeros((C, n, n), dtype=x0.dtype,
                                       device=x0.device),
                   Mv=x0.clone(), Mvv=x0[:, :, None] * x0[:, None, :],
                   m=torch.zeros((C,), dtype=torch.int32, device=x0.device),
                   beta=float(beta), scale=float(scale))


def amm_propose(x, tune: AMMTune, z, z_m):
    """The proposal from given standard normals ``z`` (fixed part) and
    ``z_m`` (adaptive part), both ``(C, dim)``: the mixture once a chain has
    adapted for more than ``2 dim`` steps, the fixed proposal before."""
    n = x.shape[1]
    dz = torch.einsum("cij,cj->ci", tune.SigmaL, z)
    dz_m = torch.einsum("cij,cj->ci", tune.SigmaLm, z_m)
    use_mix = tune.m > 2 * n
    return x + torch.where(use_mix[:, None],
                           tune.beta * dz + (1.0 - tune.beta) * dz_m, dz)


def amm_adapt(x2, tune: AMMTune) -> AMMTune:
    """The adaptation update (reference amm.jl:81-91) from the post-accept
    values ``x2 (C, dim)``."""
    n = x2.shape[1]
    mf = (tune.m + 1).to(x2.dtype)
    p = (mf / (mf + 1.0))[:, None]
    Mv = p * tune.Mv + (1.0 - p) * x2
    p = p[:, :, None]
    Mvv = p * tune.Mvv + (1.0 - p) * (x2[:, :, None] * x2[:, None, :])
    Sigma_emp = (tune.scale ** 2 / n / p) * (Mvv - Mv[:, :, None] * Mv[:, None, :])
    L_new, info = torch.linalg.cholesky_ex(Sigma_emp)
    ok = (info == 0) & torch.isfinite(L_new).all(dim=(1, 2))
    SigmaLm = torch.where(ok[:, None, None], L_new, tune.SigmaLm)
    return tune._replace(SigmaLm=SigmaLm, Mv=Mv, Mvv=Mvv, m=tune.m + 1)


def amm_step(gen, x, tune: AMMTune, logf, adapt: bool):
    f = dict(dtype=x.dtype, device=x.device)
    z = torch.randn(x.shape, generator=gen, **f)
    z_m = torch.randn(x.shape, generator=gen, **f)
    y = amm_propose(x, tune, z, z_m)
    x2, _ = metropolis_accept(gen, logf(y) - logf(x), y, x)
    return x2, (amm_adapt(x2, tune) if adapt else tune)


class AMM(SamplerSpec):
    """AMM(params, Sigma; beta=0.05, scale=2.38, adapt='all') — samples in
    link-transformed space (reference amm.jl:50-55)."""

    transform = True

    def __init__(self, params, Sigma, beta: float = 0.05, scale: float = 2.38,
                 adapt: str = "all"):
        super().__init__(params)
        if adapt not in ("all", "burnin", "none"):
            raise ValueError("adapt must be one of 'all', 'burnin', 'none'")
        self.Sigma = Sigma
        self.beta = beta
        self.scale = scale
        self.adapt_mode = adapt

    def kernel_init(self, gen, x0, logf):
        return amm_init(x0, self.Sigma, self.beta, self.scale)

    def kernel_step(self, gen, x, tune, logf, adapt):
        isadapt = {"all": True, "none": False, "burnin": adapt}[self.adapt_mode]
        return amm_step(gen, x, tune, logf, isadapt)
