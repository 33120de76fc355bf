"""Hamiltonian Monte Carlo with a fixed trajectory, batched over chains
(reference src/samplers/hmc.jl).

Every chain runs the same ``L`` leapfrog steps, so the trajectory is ``L``
batched gradient evaluations with no masking.  Random draws per step, in
order: the momentum noise ``(C, dim)`` and one acceptance uniform per chain.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .base import SamplerSpec, metropolis_accept


class HMCTune(NamedTuple):
    epsilon: torch.Tensor           # 0-d step size
    L: int                          # leapfrog steps
    SigmaL: Optional[torch.Tensor]  # (dim, dim) lower Cholesky factor, None = I


def _cholesky(Sigma, like):
    if Sigma is None:
        return None
    return torch.linalg.cholesky(torch.as_tensor(Sigma, dtype=like.dtype,
                                                 device=like.device))


def hmc_init(x0, epsilon, L, Sigma=None) -> HMCTune:
    return HMCTune(epsilon=torch.as_tensor(epsilon, dtype=x0.dtype, device=x0.device),
                   L=int(L), SigmaL=_cholesky(Sigma, x0))


def _sqnorm_Linv(SigmaL, v):
    """Per chain ``|SigmaL^-1 v|^2`` for rows ``v (C, dim)``."""
    if SigmaL is None:
        return torch.sum(v * v, dim=-1)
    w = torch.linalg.solve_triangular(SigmaL, v.T, upper=False)
    return torch.sum(w * w, dim=0)


def hmc_step(gen, x, tune: HMCTune, logfgrad):
    """Fixed-length leapfrog + MH accept (reference hmc.jl:72-111): momentum
    p = SigmaL z, z ~ N(0, I); kinetic energy 0.5 |SigmaL^-1 p|^2."""
    eps = tune.epsilon
    z = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    p0 = z if tune.SigmaL is None else z @ tune.SigmaL.T
    logf0, grad0 = logfgrad(x)
    p = p0 + 0.5 * eps * grad0
    x1, logf1, grad1 = x, logf0, grad0
    for _ in range(tune.L):
        x1 = x1 + eps * p
        logf1, grad1 = logfgrad(x1)
        p = p + eps * grad1
    p1 = p - 0.5 * eps * grad1     # undo the extra half-step (hmc.jl:96)
    K0 = 0.5 * _sqnorm_Linv(tune.SigmaL, p0)
    K1 = 0.5 * _sqnorm_Linv(tune.SigmaL, p1)
    x2, _ = metropolis_accept(gen, (logf1 - K1) - (logf0 - K0), x1, x)
    return x2, tune


class HMC(SamplerSpec):
    """HMC(params, epsilon, L; Sigma=None) — reference hmc.jl:47-58."""

    transform = True
    needs_grad = True

    def __init__(self, params, epsilon, L, Sigma=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.L = L
        self.Sigma = Sigma

    def kernel_init(self, gen, x0, logfgrad):
        return hmc_init(x0, self.epsilon, self.L, self.Sigma)

    def kernel_step(self, gen, x, tune, logfgrad, adapt):
        return hmc_step(gen, x, tune, logfgrad)
