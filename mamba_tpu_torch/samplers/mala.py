"""Metropolis-adjusted Langevin algorithm, batched over chains (reference
src/samplers/mala.jl).

Gradients are exact autodiff of the compiled block density, where the
reference takes finite differences (simulation.jl:47-51).  Random draws per
step, draw ``i`` from ``fold_in(key, i)`` of the block's per-chain keys: the
proposal noise ``(C, dim)`` and one acceptance uniform
per chain, both drawn before the step, which is one body
(``utils.graphs.Captured``): replayed from a CUDA graph in the engine, run
eagerly by the stand-alone step.

With unit mass a block may hold some sites as a data rank's slice
(``coords``, a ``parallel.mesh.BlockCoords``): the proposal noise is drawn
at the unsharded flat length and cut, and the proposal densities' sums
over coordinates are completed over the data group.  A dense ``Sigma``
keeps every site whole.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..ops import random as R
from ..parallel.mesh import WHOLE
from .base import SamplerSpec, captured, mh_select, plain
from .hmc import _cholesky, _sqnorm_Linv


class MALATune(NamedTuple):
    epsilon: torch.Tensor           # 0-d
    SigmaL: Optional[torch.Tensor]  # (dim, dim) lower Cholesky factor, None = I


def mala_init(x0, epsilon, Sigma=None) -> MALATune:
    return MALATune(epsilon=torch.as_tensor(epsilon, dtype=x0.dtype, device=x0.device),
                    SigmaL=_cholesky(Sigma, x0))


def _step(b, logfgrad, coords=WHOLE):
    """Proposal and MH test on the draws ``b["z"]`` and ``b["u"]``."""
    x, z, eps, L = b["x"], b["z"], b["eps"], b.get("SigmaL")

    def drift(g):
        return 0.5 * eps * (g if L is None else (g @ L) @ L.T)

    logf0, grad0 = logfgrad(x)
    y = x + drift(grad0) + torch.sqrt(eps) * (z if L is None else z @ L.T)
    logf1, grad1 = logfgrad(y)
    sq0, sq1 = _sqnorm_Linv(L, x - y - drift(grad1), y - x - drift(grad0),
                            coords=coords)
    q0 = -0.5 * sq0 / eps
    q1 = -0.5 * sq1 / eps
    x2, _ = mh_select(b["u"], (logf1 - q1) - (logf0 - q0), y, x)
    b["x"].copy_(x2)


def step_bodies(logfgrad_of, coords=WHOLE):
    """The step's body on the density and gradient ``logfgrad_of(state)``,
    summing over the block's ``coords``."""
    return {"body": lambda b, s: _step(b, logfgrad_of(s), coords)}


def mala_step(key, x, tune: MALATune, logfgrad, graphed=None, coords=WHOLE):
    """Proposal y = x + (eps/2) Sigma grad + sqrt(eps) SigmaL z with the
    asymmetric-proposal MH correction (reference mala.jl:67-86).
    ``graphed``: the captured step (``step_bodies``), by default the plain
    one; ``coords``: the block's coordinates on a data rank (unit mass)."""
    cap = graphed or plain(functools.partial(step_bodies, coords=coords),
                           logfgrad)
    z = coords.randn(key, x, fold=0)
    cap.load(x=x, eps=tune.epsilon, z=z,
             u=R.uniform(key, (), x.dtype, fold=1))
    if tune.SigmaL is not None:
        cap.load(SigmaL=tune.SigmaL)
    cap.run()
    return cap.bufs["x"].clone(), tune


class MALA(SamplerSpec):
    """MALA(params, epsilon; Sigma=None) — reference mala.jl:47-58.  With
    unit mass its block can hold sites as a data rank's slice; a dense
    ``Sigma`` keeps them whole."""

    transform = True
    needs_grad = True
    holds_slices = True

    def __init__(self, params, epsilon, Sigma=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.Sigma = Sigma
        self.holds_slices = Sigma is None

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density, coords=WHOLE: captured(
                             functools.partial(step_bodies, coords=coords),
                             density, grad=True))

    def kernel_init(self, key, x0, logfgrad, coords=WHOLE):
        return mala_init(x0, self.epsilon, self.Sigma)

    def kernel_step(self, key, x, tune, logfgrad, adapt, graphed=None,
                    coords=WHOLE):
        return mala_step(key, x, tune, logfgrad, graphed=graphed,
                         coords=coords)
