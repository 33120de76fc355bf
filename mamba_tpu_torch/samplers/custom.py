"""User-defined sampler blocks.

Counterpart of the reference's user-supplied ``Sampler(params, f)`` closures
(sampler.jl:20-24), e.g. the closed-form Normal/InverseGamma Gibbs updates
in the tutorial (doc/tutorial/line.jl:27-45).
"""

from __future__ import annotations

from typing import Callable

import torch

from .base import BlockKernel, SamplerSpec


class Gibbs(SamplerSpec):
    """``Gibbs(params, fn)`` with ``fn(gen, env) -> {param: new_value}``.

    ``env`` maps every node name to its current value, mirroring the
    reference's ``model[:node]`` accesses inside sampler closures: inputs
    as they are, stochastic and logical nodes chain-stacked with the chain
    axis first.  ``fn`` draws from the ``torch.Generator`` ``gen`` and
    returns chain-stacked values."""

    transform = False

    def __init__(self, params, fn: Callable):
        super().__init__(params)
        self.fn = fn

    def build(self, cm) -> BlockKernel:
        pset = set(self.params)
        nodes = torch.func.vmap(cm.eval_logicals)

        def init(gen, state):
            return ()

        def step(gen, state, tune, adapt):
            new = self.fn(gen, {**cm.inputs, **nodes(state)})
            extra = set(new) - pset
            if extra:
                raise ValueError(
                    f"Gibbs block for {self.params} returned values for "
                    f"non-block nodes {sorted(extra)}")
            return {**state, **{k: torch.as_tensor(v, dtype=cm.dtype,
                                                   device=cm.device)
                                for k, v in new.items()}}, tune

        return BlockKernel(init, step)
