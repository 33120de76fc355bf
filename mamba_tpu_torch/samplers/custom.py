"""User-defined sampler blocks.

Counterpart of the reference's user-supplied ``Sampler(params, f)`` closures
(sampler.jl:20-24), e.g. the closed-form Normal/InverseGamma Gibbs updates
in the tutorial (doc/tutorial/line.jl:27-45).

The JAX engine traces a Gibbs block's ``fn`` into the one compiled program
of each phase (``mamba_tpu/model/mcmc.py``'s ``gibbs_iter``); here the
engine replays it from a CUDA graph (``utils/graphs.py``): the block's step
is one body on a ``Captured``, which reads the per-chain keys from its
buffer ``key`` and the model state from the ``Captured``'s state, calls
``fn`` and writes the new values into buffers of the body, which the step
then copies out (the engine never writes a state tensor in place, and
``Captured.load_state`` skips a tensor it loaded before, so every value a
step returns is a fresh tensor: a copy of the block's few values).  On a
mesh's data axis ``WholeValues`` gathers over the data group inside the
body, and each gather cuts the captured body (``utils.graphs.cut``).  The
plain step, under ``utils.graphs.disabled()`` alone, calls ``fn``
eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..model.whole import WholeValues
from ..utils import graphs
from .base import BlockKernel, SamplerSpec, drawing


class Gibbs(SamplerSpec):
    """``Gibbs(params, fn)`` with ``fn(key, env) -> {param: new_value}``.

    ``env`` maps every node name to its current value, mirroring the
    reference's ``model[:node]`` accesses inside sampler closures: inputs
    as they are, stochastic and logical nodes chain-stacked with the chain
    axis first; whole, on a data axis too (``WholeValues``).  ``fn`` draws
    from the block's per-chain keys ``key (C, 2)`` (``ops/random.py``, as
    the JAX package's ``fn`` draws from its chain's key) and returns
    chain-stacked values, cast to the model's dtype and written in the
    shape of the node's state.

    As the JAX package's ``fn`` must be jit-compatible, this one must be
    capturable in a CUDA graph: it must not wait for the device
    (``.item()``, ``bool(t)``, ``nonzero``) nor copy host data to it
    (``torch.tensor(x, device=...)``).  A capture that fails raises, naming
    ``fn``; nothing falls back to the eager step.  Build the model's
    kernels under ``mamba_tpu_torch.utils.graphs.disabled()`` to run such a
    ``fn`` eagerly."""

    transform = False

    def __init__(self, params, fn: Callable):
        super().__init__(params)
        self.fn = fn

    def _values(self, cm, key, state):
        """``fn``'s new values at ``state``, checked to be block nodes."""
        new = self.fn(key, WholeValues(cm, cm.inputs,
                                       torch.func.vmap(cm.eval_logicals)(
                                           cm.with_wholes(state))))
        extra = set(new) - set(self.params)
        if extra:
            raise ValueError(
                f"Gibbs block for {self.params} returned values for "
                f"non-block nodes {sorted(extra)}")
        return new

    def build(self, cm) -> BlockKernel:
        def init(key, state):
            return ()

        if not graphs.enabled():
            def step(key, state, tune, adapt):
                new = self._values(cm, key, state)
                return {**state, **{k: torch.as_tensor(v, dtype=cm.dtype,
                                                       device=cm.device)
                                    for k, v in new.items()}}, tune
            return BlockKernel(init, step)

        def body(b, s):
            new = self._values(cm, b["key"], s)
            for k, v in new.items():
                if isinstance(v, torch.Tensor):
                    b[k].copy_(v)
                else:
                    b[k].fill_(v)
            return tuple(new)

        body.func = self.fn            # the capture's error names ``fn``
        cap = drawing(body)

        def step(key, state, tune, adapt):
            cap.load(key=key)
            for k in self.params:
                if not cap.holds(k, state[k]):
                    cap.load(**{k: state[k]})
            cap.load_state(state)
            names = cap.run()
            return {**state, **{k: cap.bufs[k].clone() for k in names}}, tune

        return BlockKernel(init, step)
