"""Missing-value imputation sampler (reference src/samplers/miss.jl).

NaN entries of an observed node's init values mark missingness.  The
reference scans for NaNs at iteration 1 (miss.jl:44-52); here the mask is
resolved once at build time from the compiled model's example values and
every step redraws exactly those entries, for every chain, from the node's
current predictive distribution — one masked ``torch.where`` per site instead
of the reference's per-index loops (miss.jl:70-86).

The engine's chain initializer prior-imputes NaN inits before the first
iteration — the reference gets the same effect because MISS runs inside
iteration 1 before any likelihood-consuming block touches the node.

Random draws per step: one ``forward_sample`` of each masked site, in the
order of ``params``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BlockKernel, SamplerSpec


def missing_masks(cm, params) -> dict[str, np.ndarray]:
    """NaN masks of the given observed sites (empty-mask sites are dropped,
    mirroring miss.jl:47-49)."""
    masks = {}
    for name in params:
        m = np.isnan(cm.example_values[name])
        if m.any():
            masks[name] = m
    return masks


class MISS(SamplerSpec):
    """MISS(params) — imputation block for observed nodes with NaN entries
    (reference MISS ctor, miss.jl:41-62)."""

    transform = False

    def build(self, cm) -> BlockKernel:
        masks = {n: torch.as_tensor(m, device=cm.device)
                 for n, m in missing_masks(cm, self.params).items()}

        def init(gen, state):
            return ()

        def step(gen, state, tune, adapt):
            for name, mask in masks.items():
                draw = cm.forward_sample(gen, state, names=(name,))[name]
                state = {**state, name: torch.where(mask, draw, state[name])}
            return state, tune

        return BlockKernel(init, step)
