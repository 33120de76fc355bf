"""Adaptive Metropolis-within-Gibbs, batched over chains (reference
src/samplers/amwg.jl).

A per-coordinate random-walk sweep over chain-stacked ``x (C, dim)``: each
coordinate's proposal is accepted or rejected for every chain at once.  The
sweep, its ``dim`` density calls included, is one body
(``utils.graphs.Captured``), replayed from a CUDA graph in the engine and
run eagerly by the stand-alone step; the adaptation after it runs eagerly.  Proposal scales adapt per chain and per
coordinate in batches toward a 0.44 acceptance target, as each of the
reference's per-process chains does.  The iteration counter is the same for
every chain, so it is a host integer.

Random draws per step, draw ``i`` of them from ``fold_in(key, i)`` of the
block's per-chain keys: the proposal noise ``(C, dim)`` (normal)
and the acceptance uniforms ``(C, dim)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import random as R
from .base import SamplerSpec, captured, plain


class AMWGTune(NamedTuple):
    sigma: torch.Tensor   # (C, dim) proposal std
    accept: torch.Tensor  # (C, dim) int32 acceptances since adaptation began
    m: int                # adaptation iterations so far
    batchsize: int
    target: float
    #: the fields held per chain, chain axis first (a sharded run's chain
    #: file joins them over the chain ranks: ``output.fileio``)
    CHAIN_LEAVES = ("sigma", "accept")


def amwg_init(x0, sigma, batchsize: int = 50, target: float = 0.44) -> AMWGTune:
    sigma = torch.as_tensor(sigma, dtype=x0.dtype, device=x0.device)
    return AMWGTune(sigma=sigma.expand(x0.shape).clone(),
                    accept=torch.zeros(x0.shape, dtype=torch.int32,
                                       device=x0.device),
                    m=0, batchsize=int(batchsize), target=float(target))


def _sweep(b, logf):
    """The coordinate sweep on the draws ``b["noise"]`` (normal) and
    ``b["u"]`` (uniform), both ``(C, dim)``: the new ``b["x"]`` and which
    proposals were taken, ``b["accepted"]``."""
    x = b["x"]
    z = b["sigma"] * b["noise"]
    logu = torch.log(b["u"])
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
    b["x"].copy_(x)
    b["accepted"].copy_(torch.stack(accepted, dim=1))


def sweep_bodies(logf_of):
    """The sweep's body on the density ``logf_of(state)``."""
    return {"body": lambda b, s: _sweep(b, logf_of(s))}


def amwg_step(key, x, tune: AMWGTune, logf, adapt: bool, graphed=None):
    """One coordinate sweep and, on adaptation steps, the batch scale update
    (reference amwg.jl:68-115).  ``graphed``: the captured sweep
    (``sweep_bodies``), by default the plain loop."""
    cap = graphed or plain(sweep_bodies, logf)
    if not cap.holds("x", x):
        cap.load(accepted=torch.zeros(x.shape, dtype=torch.bool, device=x.device))
    cap.load(x=x, sigma=tune.sigma,
             noise=R.normal(key, x.shape[1:], x.dtype, fold=0),
             u=R.uniform(key, x.shape[1:], x.dtype, fold=1))
    cap.run()
    x = cap.bufs["x"].clone()
    if not adapt:
        return x, tune
    accept = tune.accept + cap.bufs["accepted"].to(torch.int32)
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

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(sweep_bodies, density))

    def kernel_init(self, key, x0, logf):
        return amwg_init(x0, self.sigma, self.batchsize, self.target)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        isadapt = {"all": True, "none": False, "burnin": adapt}[self.adapt_mode]
        return amwg_step(key, x, tune, logf, isadapt, graphed=graphed)
