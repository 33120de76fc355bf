"""Random-walk Metropolis, batched over chains (reference
src/samplers/rwm.jl).

Random draws per step, in order: the proposal noise ``(C, dim)`` (normal,
or uniform on [-1, 1)) and one acceptance uniform per chain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import SamplerSpec, metropolis_accept


class RWMTune(NamedTuple):
    scale: torch.Tensor  # 0-d or (dim,), shared by every chain


def rwm_init(x0, scale) -> RWMTune:
    return RWMTune(scale=torch.as_tensor(scale, dtype=x0.dtype, device=x0.device))


def rwm_step(gen, x, tune: RWMTune, logf, proposal: str = "normal"):
    """One MH step with a symmetric proposal for chains ``x (C, dim)``
    (reference rwm.jl:65-71).  ``proposal``: 'normal' or 'uniform'
    (SymUniform), the reference's SymDistributionType argument."""
    f = dict(dtype=x.dtype, device=x.device)
    if proposal == "uniform":
        z = 2.0 * torch.rand(x.shape, generator=gen, **f) - 1.0
    else:
        z = torch.randn(x.shape, generator=gen, **f)
    y = x + tune.scale * z
    x2, _ = metropolis_accept(gen, logf(y) - logf(x), y, x)
    return x2, tune


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

    def kernel_init(self, gen, x0, logf):
        return rwm_init(x0, self.scale)

    def kernel_step(self, gen, x, tune, logf, adapt):
        return rwm_step(gen, x, tune, logf, proposal=self.proposal)
