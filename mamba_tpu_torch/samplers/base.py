"""Sampler scaffolding: block kernels over an explicit chain axis.

Counterpart of reference src/samplers/sampler.jl (Sampler, SamplingBlock,
SamplerVariate).  Two levels, as in the JAX package:

1. **Stand-alone kernels**: each sampler module exposes
   ``<name>_init(gen, x0, ...) -> tune`` and ``<name>_step(gen, x, tune,
   logf, adapt) -> (x', tune')`` on chain-stacked flat vectors ``x (C,
   dim)`` with a user-supplied batched log-density — usable with no Model.

2. **Engine specs**: ``SamplerSpec`` subclasses bind a kernel to a block of
   model nodes.  ``build(compiled_model)`` returns a ``BlockKernel`` whose
   ``step(gen, state, tune, adapt) -> (state, tune)`` updates chain-stacked
   state dicts.  The compiled model's per-chain functions are batched with
   ``torch.func.vmap``; random draws come from the run's ``torch.Generator``
   outside it.

``adapt`` is a Python bool (``iter <= burnin`` in the reference, e.g.
nuts.jl:52): the engine's loop runs on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class BlockKernel(NamedTuple):
    init: Callable   # (gen, state) -> tune
    step: Callable   # (gen, state, tune, adapt) -> (state, tune)


class SamplerSpec:
    """Base class for block sampler assignments (reference Sampler ctor,
    sampler.jl:20-24)."""

    #: operate on link-transformed (unconstrained) values?
    transform: bool = False
    #: does the kernel consume (logf, grad) rather than logf?
    needs_grad: bool = False

    def __init__(self, params):
        if isinstance(params, str):
            params = (params,)
        self.params = tuple(params)

    # -- subclass hooks --------------------------------------------------
    def kernel_init(self, gen, x0, logf) -> object:
        raise NotImplementedError

    def kernel_step(self, gen, x, tune, logf, adapt):
        raise NotImplementedError

    # -- engine wiring ---------------------------------------------------
    def build(self, cm) -> BlockKernel:
        pack, unpack, spec, logf = cm.block_functions(self.params, self.transform)
        vpack = torch.func.vmap(pack)
        vunpack = torch.func.vmap(unpack)

        if self.needs_grad:
            grad_value = torch.func.vmap(torch.func.grad_and_value(logf))

            def make_f(state):
                def f(x):
                    g, v = grad_value(x, state)
                    return v, g
                return f
        else:
            vlogf = torch.func.vmap(logf)

            def make_f(state):
                return lambda x: vlogf(x, state)

        def init(gen, state):
            return self.kernel_init(gen, vpack(state), make_f(state))

        def step(gen, state, tune, adapt):
            x = vpack(state)
            x2, tune2 = self.kernel_step(gen, x, tune, make_f(state), adapt)
            return {**state, **vunpack(x2, state)}, tune2

        return BlockKernel(init, step)

    def __repr__(self):
        return f"{type(self).__name__}({list(self.params)})"


def metropolis_accept(gen, log_ratio, x_new, x_old):
    """Per-chain MH accept: row ``c`` of ``x_new (C, dim)`` is taken with
    probability ``exp(log_ratio[c])``; one uniform per chain."""
    u = torch.rand(log_ratio.shape, generator=gen, dtype=log_ratio.dtype,
                   device=log_ratio.device)
    accept = torch.log(u) < log_ratio
    return torch.where(accept[:, None], x_new, x_old), accept
