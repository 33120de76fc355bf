"""User-defined sampler blocks.

Counterpart of the reference's user-supplied ``Sampler(params, f)`` closures
(sampler.jl:20-24), e.g. the closed-form Normal/InverseGamma Gibbs updates
in the tutorial (doc/tutorial/line.jl:27-45).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable

import torch

from .base import BlockKernel, SamplerSpec


class WholeValues(Mapping):
    """Every node's value as a Gibbs or custom block reads it: whole.  A
    value that this data rank holds in part (``cm.local_dims``) is gathered
    over the data group when it is first read in a step (a collective:
    every data rank runs the same function on the same stream, so all read
    the same keys in the same order); one that no rank can read whole
    raises, naming it.  Inputs are unstacked, every other value
    chain-stacked."""

    def __init__(self, cm, inputs: dict, nodes: dict):
        self._cm, self._inputs, self._nodes = cm, inputs, nodes
        self._whole: dict = {}

    def __getitem__(self, name):
        if name not in self._whole:
            if name in self._nodes:
                self._whole[name] = self._cm.whole(name, self._nodes[name], 1)
            else:
                self._whole[name] = self._cm.whole(name, self._inputs[name])
        return self._whole[name]

    def __iter__(self):
        yield from self._inputs
        yield from (n for n in self._nodes if n not in self._inputs)

    def __len__(self):
        return len(set(self._inputs) | set(self._nodes))


class Gibbs(SamplerSpec):
    """``Gibbs(params, fn)`` with ``fn(gen, env) -> {param: new_value}``.

    ``env`` maps every node name to its current value, mirroring the
    reference's ``model[:node]`` accesses inside sampler closures: inputs
    as they are, stochastic and logical nodes chain-stacked with the chain
    axis first; whole, on a data axis too (``WholeValues``).  ``fn`` draws
    from the ``torch.Generator`` ``gen`` and returns chain-stacked
    values."""

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
            new = self.fn(gen, WholeValues(cm, cm.inputs, nodes(state)))
            extra = set(new) - pset
            if extra:
                raise ValueError(
                    f"Gibbs block for {self.params} returned values for "
                    f"non-block nodes {sorted(extra)}")
            return {**state, **{k: torch.as_tensor(v, dtype=cm.dtype,
                                                   device=cm.device)
                                for k, v in new.items()}}, tune

        return BlockKernel(init, step)
