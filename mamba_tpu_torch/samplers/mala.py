"""Metropolis-adjusted Langevin algorithm, batched over chains (reference
src/samplers/mala.jl).

Gradients are exact autodiff of the compiled block density, where the
reference takes finite differences (simulation.jl:47-51).  Random draws per
step, in order: the proposal noise ``(C, dim)`` and one acceptance uniform
per chain, both drawn before the step, which is one body
(``utils.graphs.Captured``): replayed from a CUDA graph in the engine, run
eagerly by the stand-alone step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .base import SamplerSpec, captured, mh_select, plain
from .hmc import _cholesky, _sqnorm_Linv


class MALATune(NamedTuple):
    epsilon: torch.Tensor           # 0-d
    SigmaL: Optional[torch.Tensor]  # (dim, dim) lower Cholesky factor, None = I


def mala_init(x0, epsilon, Sigma=None) -> MALATune:
    return MALATune(epsilon=torch.as_tensor(epsilon, dtype=x0.dtype, device=x0.device),
                    SigmaL=_cholesky(Sigma, x0))


def _step(b, logfgrad):
    """Proposal and MH test on the draws ``b["z"]`` and ``b["u"]``."""
    x, z, eps, L = b["x"], b["z"], b["eps"], b.get("SigmaL")

    def drift(g):
        return 0.5 * eps * (g if L is None else (g @ L) @ L.T)

    logf0, grad0 = logfgrad(x)
    y = x + drift(grad0) + torch.sqrt(eps) * (z if L is None else z @ L.T)
    logf1, grad1 = logfgrad(y)
    q0 = -0.5 * _sqnorm_Linv(L, x - y - drift(grad1)) / eps
    q1 = -0.5 * _sqnorm_Linv(L, y - x - drift(grad0)) / eps
    x2, _ = mh_select(b["u"], (logf1 - q1) - (logf0 - q0), y, x)
    b["x"].copy_(x2)


def step_bodies(logfgrad_of):
    """The step's body on the density and gradient ``logfgrad_of(state)``."""
    return {"body": lambda b, s: _step(b, logfgrad_of(s))}


def mala_step(gen, x, tune: MALATune, logfgrad, graphed=None):
    """Proposal y = x + (eps/2) Sigma grad + sqrt(eps) SigmaL z with the
    asymmetric-proposal MH correction (reference mala.jl:67-86).
    ``graphed``: the captured step (``step_bodies``), by default the plain
    one."""
    f = dict(dtype=x.dtype, device=x.device)
    cap = graphed or plain(step_bodies, logfgrad)
    z = torch.randn(x.shape, generator=gen, **f)
    cap.load(x=x, eps=tune.epsilon, z=z,
             u=torch.rand(x.shape[:1], generator=gen, **f))
    if tune.SigmaL is not None:
        cap.load(SigmaL=tune.SigmaL)
    cap.run()
    return cap.bufs["x"].clone(), tune


class MALA(SamplerSpec):
    """MALA(params, epsilon; Sigma=None) — reference mala.jl:47-58."""

    transform = True
    needs_grad = True

    def __init__(self, params, epsilon, Sigma=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.Sigma = Sigma

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(step_bodies, density,
                                                          grad=True))

    def kernel_init(self, gen, x0, logfgrad):
        return mala_init(x0, self.epsilon, self.Sigma)

    def kernel_step(self, gen, x, tune, logfgrad, adapt, graphed=None):
        return mala_step(gen, x, tune, logfgrad, graphed=graphed)
