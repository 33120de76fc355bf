"""Random-walk Metropolis, batched over chains (reference
src/samplers/rwm.jl).

Random draws per step, draw ``i`` of them from ``fold_in(key, i)`` of the
block's per-chain keys: the proposal noise ``(C, dim)`` (normal,
or uniform on [-1, 1)) and one acceptance uniform per chain, both drawn
before the step's body (``utils.graphs.Captured``), which the engine
replays from a CUDA graph and the stand-alone step runs eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import random as R
from .base import SamplerSpec, captured, mh_select, plain


class RWMTune(NamedTuple):
    scale: torch.Tensor  # 0-d or (dim,), shared by every chain


def rwm_init(x0, scale) -> RWMTune:
    return RWMTune(scale=torch.as_tensor(scale, dtype=x0.dtype, device=x0.device))


def _step(b, logf, proposal):
    """Proposal and MH test on the draws ``b["noise"]`` and ``b["u"]``."""
    x = b["x"]
    z = 2.0 * b["noise"] - 1.0 if proposal == "uniform" else b["noise"]
    y = x + b["scale"] * z
    x2, _ = mh_select(b["u"], logf(y) - logf(x), y, x)
    b["x"].copy_(x2)


def step_bodies(logf_of, proposal="normal"):
    """The step's body on the density ``logf_of(state)``."""
    return {"body": lambda b, s: _step(b, logf_of(s), proposal)}


def rwm_step(key, x, tune: RWMTune, logf, proposal: str = "normal",
             graphed=None):
    """One MH step with a symmetric proposal for chains ``x (C, dim)``
    (reference rwm.jl:65-71).  ``proposal``: 'normal' or 'uniform'
    (SymUniform), the reference's SymDistributionType argument.
    ``graphed``: the captured step (``step_bodies``), by default the plain
    one."""
    cap = graphed or plain(functools.partial(step_bodies, proposal=proposal), logf)
    draw = R.uniform if proposal == "uniform" else R.normal
    cap.load(x=x, scale=tune.scale, noise=draw(key, x.shape[1:], x.dtype, fold=0),
             u=R.uniform(key, (), x.dtype, fold=1))
    cap.run()
    return cap.bufs["x"].clone(), tune


class RWM(SamplerSpec):
    """RWM(params, scale; proposal='normal') — samples in link-transformed
    space (reference rwm.jl:49-58 uses SamplingBlock(..., true))."""

    transform = True

    def __init__(self, params, scale, proposal: str = "normal"):
        super().__init__(params)
        if proposal not in ("normal", "uniform"):
            raise ValueError("proposal must be 'normal' or 'uniform'")
        self.scale = scale
        self.proposal = proposal

    def build(self, cm):
        bodies = functools.partial(step_bodies, proposal=self.proposal)
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bodies, density))

    def kernel_init(self, key, x0, logf):
        return rwm_init(x0, self.scale)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        return rwm_step(key, x, tune, logf, proposal=self.proposal,
                        graphed=graphed)
