"""Sampler scaffolding: block kernels over an explicit chain axis.

Counterpart of reference src/samplers/sampler.jl (Sampler, SamplingBlock,
SamplerVariate).  Two levels, as in the JAX package:

1. **Stand-alone kernels**: each sampler module exposes
   ``<name>_init(gen, x0, ...) -> tune`` and ``<name>_step(gen, x, tune,
   logf, adapt) -> (x', tune')`` on chain-stacked flat vectors ``x (C,
   dim)`` with a user-supplied batched log-density — usable with no Model.
   ``logf(x (C, dim)) -> (C,)``; the kernels that score several candidate
   points per chain at once (DGS, BHMC, BIA, BMC3, BMG) also call it on
   ``(C, m, dim)`` and take ``(C, m)`` back.

2. **Engine specs**: ``SamplerSpec`` subclasses bind a kernel to a block of
   model nodes.  ``build(compiled_model)`` returns a ``BlockKernel`` whose
   ``step(gen, state, tune, adapt) -> (state, tune)`` updates chain-stacked
   state dicts.  The compiled model's per-chain functions are batched with
   ``torch.func.vmap``; random draws come from the run's ``torch.Generator``
   outside it.

``adapt`` is a Python bool (``iter <= burnin`` in the reference, e.g.
nuts.jl:52): the engine's loop runs on the host.

Under a mesh's data axis a block's ``logf`` on one rank is a part of its
density; every vmapped value and gradient is summed over the data group
(``cm.block_sum``) right after the vmapped call, outside it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
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
        return self.bind(cm, self.kernel_init, self.kernel_step)

    def bind(self, cm, kernel_init, kernel_step) -> BlockKernel:
        """The block kernel that runs ``kernel_init(gen, x0, f)`` and
        ``kernel_step(gen, x, tune, f, adapt)`` on the block's flat vectors,
        ``f`` being the batched density (and gradient)."""
        pack, unpack, spec, logf = cm.block_functions(self.params, self.transform)
        vpack = torch.func.vmap(pack)
        vunpack = torch.func.vmap(unpack)
        total = cm.block_sum(self.params)

        if self.needs_grad:
            grad_value = torch.func.vmap(torch.func.grad_and_value(logf))

            def make_f(state):
                def f(x):
                    g, v = grad_value(x, state)
                    return total(v, g)
                return f
        else:
            vlogf = summed(torch.func.vmap(logf), total)

            def make_f(state):
                return candidate_logf(vlogf, state)

        def init(gen, state):
            return kernel_init(gen, vpack(state), make_f(state))

        def step(gen, state, tune, adapt):
            x = vpack(state)
            x2, tune2 = kernel_step(gen, x, tune, make_f(state), adapt)
            return {**state, **vunpack(x2, state)}, tune2

        return BlockKernel(init, step)

    def __repr__(self):
        return f"{type(self).__name__}({list(self.params)})"


def summed(vlogf, total):
    """``vlogf`` followed by ``total`` (``cm.block_sum``) on its value."""
    def f(x, state):
        return total(vlogf(x, state))[0]
    return f


def candidate_logf(vlogf, state):
    """``x -> vlogf(x, state)`` for chain-stacked points ``x (C, dim)``, and
    for ``m`` candidate points per chain ``x (C, m, dim) -> (C, m)``: the
    candidates are folded into the chain axis against the state repeated
    ``m`` times (once per ``m``), which dispatches faster than a second
    ``vmap``."""
    repeated = {}

    def f(x):
        if x.dim() == 2:
            return vlogf(x, state)
        C, m = x.shape[:2]
        if m not in repeated:
            repeated[m] = {k: v[:, None].expand((C, m) + v.shape[1:]).reshape(
                (C * m,) + v.shape[1:]) for k, v in state.items()}
        return vlogf(x.reshape(C * m, -1), repeated[m]).reshape(C, m)
    return f


def validate(x):
    """No-op validator: continuous-support kernels accept any vector
    (reference sampler.jl:72)."""
    return x


def _host(x):
    """``x`` as a numpy array on the host.  The validators run once, at
    stand-alone kernel construction, so the copy is not on any loop."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validatebinary(x):
    """Require every element to be 0/1 (reference sampler.jl:75-79)."""
    arr = _host(x)
    if not np.all((arr == 0) | (arr == 1)):
        raise ValueError("variate is not a binary vector")
    return x


def validatesimplex(x, atol: float = 1e-8):
    """Require a probability vector (reference sampler.jl:81-83): entries at
    least ``-atol`` and a sum within 1e-6 of 1.  Chain-stacked ``x (C, K)``
    is checked row by row."""
    arr = _host(x)
    if not (np.all(arr >= -atol)
            and np.all(np.abs(arr.sum(-1) - 1.0) < 1e-6)):
        raise ValueError("variate is not a probability vector")
    return x


def metropolis_accept(gen, log_ratio, x_new, x_old):
    """Per-chain MH accept: row ``c`` of ``x_new (C, dim)`` is taken with
    probability ``exp(log_ratio[c])``; one uniform per chain."""
    u = torch.rand(log_ratio.shape, generator=gen, dtype=log_ratio.dtype,
                   device=log_ratio.device)
    accept = torch.log(u) < log_ratio
    return torch.where(accept[:, None], x_new, x_old), accept
