"""Adaptive Metropolis-within-Gibbs, batched over chains (reference
src/samplers/amwg.jl).

A per-coordinate random-walk sweep over chain-stacked ``x (C, dim)``: the
host loops over coordinates, and each coordinate's proposal is accepted or
rejected for every chain at once.  Proposal scales adapt per chain and per
coordinate in batches toward a 0.44 acceptance target, as each of the
reference's per-process chains does.  The iteration counter is the same for
every chain, so it is a host integer.

Random draws per step, in order: the proposal noise ``(C, dim)`` (normal)
and the acceptance uniforms ``(C, dim)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import SamplerSpec


class AMWGTune(NamedTuple):
    sigma: torch.Tensor   # (C, dim) proposal std
    accept: torch.Tensor  # (C, dim) int32 acceptances since adaptation began
    m: int                # adaptation iterations so far
    batchsize: int
    target: float


def amwg_init(x0, sigma, batchsize: int = 50, target: float = 0.44) -> AMWGTune:
    sigma = torch.as_tensor(sigma, dtype=x0.dtype, device=x0.device)
    return AMWGTune(sigma=sigma.expand(x0.shape).clone(),
                    accept=torch.zeros(x0.shape, dtype=torch.int32,
                                       device=x0.device),
                    m=0, batchsize=int(batchsize), target=float(target))


def amwg_step(gen, x, tune: AMWGTune, logf, adapt: bool):
    """One coordinate sweep and, on adaptation steps, the batch scale update
    (reference amwg.jl:68-115)."""
    f = dict(dtype=x.dtype, device=x.device)
    z = tune.sigma * torch.randn(x.shape, generator=gen, **f)
    logu = torch.log(torch.rand(x.shape, generator=gen, **f))
    logf0 = logf(x)
    accepted = []
    for i in range(x.shape[1]):
        y = x.clone()
        y[:, i] += z[:, i]
        logf1 = logf(y)
        acc = logu[:, i] < logf1 - logf0
        x = torch.where(acc[:, None], y, x)
        logf0 = torch.where(acc, logf1, logf0)
        accepted.append(acc)
    if not adapt:
        return x, tune
    accept = tune.accept + torch.stack(accepted, dim=1).to(torch.int32)
    m = tune.m + 1
    sigma = tune.sigma
    if m % tune.batchsize == 0:
        delta = torch.full_like(sigma, min(0.01, (m / tune.batchsize) ** -0.5))
        rate = accept.to(sigma.dtype) / m
        sigma = sigma * torch.exp(torch.where(rate < tune.target, -delta, delta))
    return x, tune._replace(sigma=sigma, accept=accept, m=m)


class AMWG(SamplerSpec):
    """AMWG(params, sigma; batchsize=50, target=0.44, adapt='all') — samples
    in link-transformed space (reference amwg.jl:52-57).  ``adapt``: 'all'
    adapts on every iteration, 'burnin' during burnin only, 'none' never."""

    transform = True

    def __init__(self, params, sigma, batchsize: int = 50, target: float = 0.44,
                 adapt: str = "all"):
        super().__init__(params)
        if adapt not in ("all", "burnin", "none"):
            raise ValueError("adapt must be one of 'all', 'burnin', 'none'")
        self.sigma = sigma
        self.batchsize = batchsize
        self.target = target
        self.adapt_mode = adapt

    def kernel_init(self, gen, x0, logf):
        return amwg_init(x0, self.sigma, self.batchsize, self.target)

    def kernel_step(self, gen, x, tune, logf, adapt):
        isadapt = {"all": True, "none": False, "burnin": adapt}[self.adapt_mode]
        return amwg_step(gen, x, tune, logf, isadapt)
