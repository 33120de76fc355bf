"""Adaptive Mixture Metropolis, batched over chains (reference
src/samplers/amm.jl).

Haario-style adaptive Metropolis: beta-mixture of a fixed proposal and a
running empirical-covariance proposal, each chain with its own moments and
factor.  The reference guards rank deficiency with a pivoted Cholesky
(amm.jl:87-89); here ``torch.linalg.cholesky_ex`` factors every chain's
empirical covariance at once and reports per chain whether it was positive
definite, and a chain whose covariance was not keeps its previous factor.

Random draws per step, draw ``i`` of them from ``fold_in(key, i)`` of the
block's per-chain keys: the fixed proposal's normals ``(C, dim)``,
the adaptive proposal's normals ``(C, dim)``, the acceptance uniforms
``(C,)``, all drawn before the proposal and MH test, which are one body
(``utils.graphs.Captured``): replayed from a CUDA graph in the engine, run
eagerly by the stand-alone step.  The adaptation runs eagerly after it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import random as R
from .base import SamplerSpec, captured, mh_select, plain


class AMMTune(NamedTuple):
    SigmaL: torch.Tensor    # (C, dim, dim) fixed proposal Cholesky
    SigmaLm: torch.Tensor   # (C, dim, dim) adaptive (empirical) proposal Cholesky
    Mv: torch.Tensor        # (C, dim) running mean
    Mvv: torch.Tensor       # (C, dim, dim) running second moment
    m: torch.Tensor         # (C,) int32 adaptation steps so far
    beta: float
    scale: float
    #: the fields held per chain, chain axis first (a sharded run's chain
    #: file joins them over the chain ranks: ``output.fileio``)
    CHAIN_LEAVES = ("SigmaL", "SigmaLm", "Mv", "Mvv", "m")


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


def _step(b, logf, beta):
    """Proposal and MH test on the draws ``b["z"]``, ``b["z_m"]`` and
    ``b["u"]``, from the factors and counts in ``b``."""
    x = b["x"]
    tune = AMMTune(SigmaL=b["SigmaL"], SigmaLm=b["SigmaLm"], Mv=None, Mvv=None,
                   m=b["m"], beta=beta, scale=None)
    y = amm_propose(x, tune, b["z"], b["z_m"])
    x2, _ = mh_select(b["u"], logf(y) - logf(x), y, x)
    b["x"].copy_(x2)


def step_bodies(logf_of, beta):
    """The step's body on the density ``logf_of(state)``."""
    return {"body": lambda b, s: _step(b, logf_of(s), beta)}


def amm_step(key, x, tune: AMMTune, logf, adapt: bool, graphed=None):
    """One AMM step; ``graphed``: the captured proposal and MH test
    (``step_bodies``), by default the plain one."""
    cap = graphed or plain(functools.partial(step_bodies, beta=tune.beta), logf)
    cap.load(x=x, SigmaL=tune.SigmaL, SigmaLm=tune.SigmaLm, m=tune.m,
             z=R.normal(key, x.shape[1:], x.dtype, fold=0),
             z_m=R.normal(key, x.shape[1:], x.dtype, fold=1),
             u=R.uniform(key, (), x.dtype, fold=2))
    cap.run()
    x2 = cap.bufs["x"].clone()
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

    def build(self, cm):
        bodies = functools.partial(step_bodies, beta=float(self.beta))
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bodies, density))

    def kernel_init(self, key, x0, logf):
        return amm_init(x0, self.Sigma, self.beta, self.scale)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        isadapt = {"all": True, "none": False, "burnin": adapt}[self.adapt_mode]
        return amm_step(key, x, tune, logf, isadapt, graphed=graphed)
