"""Metropolis-adjusted Langevin algorithm, batched over chains (reference
src/samplers/mala.jl).

Gradients are exact autodiff of the compiled block density, where the
reference takes finite differences (simulation.jl:47-51).  Random draws per
step, in order: the proposal noise ``(C, dim)`` and one acceptance uniform
per chain.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .base import SamplerSpec, metropolis_accept
from .hmc import _cholesky, _sqnorm_Linv


class MALATune(NamedTuple):
    epsilon: torch.Tensor           # 0-d
    SigmaL: Optional[torch.Tensor]  # (dim, dim) lower Cholesky factor, None = I


def mala_init(x0, epsilon, Sigma=None) -> MALATune:
    return MALATune(epsilon=torch.as_tensor(epsilon, dtype=x0.dtype, device=x0.device),
                    SigmaL=_cholesky(Sigma, x0))


def mala_step(gen, x, tune: MALATune, logfgrad):
    """Proposal y = x + (eps/2) Sigma grad + sqrt(eps) SigmaL z with the
    asymmetric-proposal MH correction (reference mala.jl:67-86)."""
    eps, L = tune.epsilon, tune.SigmaL
    z = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)

    def drift(g):
        return 0.5 * eps * (g if L is None else (g @ L) @ L.T)

    logf0, grad0 = logfgrad(x)
    y = x + drift(grad0) + torch.sqrt(eps) * (z if L is None else z @ L.T)
    logf1, grad1 = logfgrad(y)
    q0 = -0.5 * _sqnorm_Linv(L, x - y - drift(grad1)) / eps
    q1 = -0.5 * _sqnorm_Linv(L, y - x - drift(grad0)) / eps
    x2, _ = metropolis_accept(gen, (logf1 - q1) - (logf0 - q0), y, x)
    return x2, tune


class MALA(SamplerSpec):
    """MALA(params, epsilon; Sigma=None) — reference mala.jl:47-58."""

    transform = True
    needs_grad = True

    def __init__(self, params, epsilon, Sigma=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.Sigma = Sigma

    def kernel_init(self, gen, x0, logfgrad):
        return mala_init(x0, self.epsilon, self.Sigma)

    def kernel_step(self, gen, x, tune, logfgrad, adapt):
        return mala_step(gen, x, tune, logfgrad)
