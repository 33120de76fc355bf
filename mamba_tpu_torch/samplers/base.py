"""Sampler scaffolding: block kernels over an explicit chain axis.

Counterpart of reference src/samplers/sampler.jl (Sampler, SamplingBlock,
SamplerVariate).  Two levels, as in the JAX package:

1. **Stand-alone kernels**: each sampler module exposes
   ``<name>_init(key, x0, ...) -> tune`` and ``<name>_step(key, x, tune,
   logf, adapt) -> (x', tune')`` on chain-stacked flat vectors ``x (C,
   dim)`` and per-chain keys ``key (C, 2)`` (``ops/random.py``) with a user-supplied batched log-density — usable with no Model.
   ``logf(x (C, dim)) -> (C,)``; the kernels that score several candidate
   points per chain at once (DGS, BHMC, BIA, BMC3, BMG) also call it on
   ``(C, m, dim)`` and take ``(C, m)`` back.

2. **Engine specs**: ``SamplerSpec`` subclasses bind a kernel to a block of
   model nodes.  ``build(compiled_model)`` returns a ``BlockKernel`` whose
   ``step(key, state, tune, adapt) -> (state, tune)`` updates chain-stacked
   state dicts.  The compiled model's per-chain functions are batched with
   ``torch.func.vmap``; random draws come from the block's per-chain keys
   outside it.  A step draws its fixed draws from ``fold_in(key, i)`` and
   a loop's round ``j`` (NUTS's doublings, a slice sampler's trip batches,
   ABC's batches of draws, BHMC's wall hits) from keys folded with ``j``,
   never from a stream that the rounds take turns on: a chain's numbers do
   not depend on how many rounds the other chains on its rank take.

``adapt`` is a Python bool (``iter <= burnin`` in the reference, e.g.
nuts.jl:52): the engine's loop runs on the host.  The samplers' inner
loops (NUTS's leaves, ChEES's and HMC's leapfrogs, the slice samplers'
shrink trips, AMWG's sweep, BHMC's wall hits, the whole step of RWM,
AMM, MALA, BIA, BMC3 and BMG, ABC's batches of draws, MISS's
imputations and a Gibbs block's call of its user ``fn``) are replayed
from CUDA graphs in the engine (``SamplerSpec.bind``'s ``graphed``,
``utils/graphs.py``); the stand-alone kernels run their plain loops, so
they take any ``logf``, capturable or not.  Both forms run the same
bodies and draw the same numbers in the same layout.  A Gibbs ``fn`` must
be capturable, as the JAX package's must be jit-compatible: one that reads
the host fails its capture, which raises with ``graphs.disabled()`` as
the way out (``samplers/custom.py``).

Under a mesh's data axis a block's ``logf`` on one rank is a part of its
density; every vmapped value and gradient is completed over the data group
(``cm.block_sum``, one all-reduce) right after the vmapped call, outside
it.  Such a block replays too: its captured bodies are cut at each
collective (the density's all-reduce, a sum over coordinates, the
all-gather of a whole value), and the collectives run between the
segments' replays (``utils/graphs.py``), as GSPMD puts them into the JAX
package's compiled program; only ``utils.graphs.disabled()`` gives the
plain loops.  A block of a sampler that can hold slices (``holds_slices``:
NUTS, ChEES-HMC, HMC and MALA with unit mass) holds each named sampled site as
the rank's slice where the compiler allows it: its flat vector is the
rank's coordinates, and ``bind`` gives the kernels the block's
coordinates (``coords=``, a ``parallel.mesh.BlockCoords``), whose sums
over coordinates are completed over the data group and whose normal draws
are the unsharded run's, at the rank's counters.  Such a block's all-reduce carries the value
and the whole coordinates' gradient alone.  The stand-alone kernels sum
with ``torch.sum`` over the last dim by default, so they take any
``logf``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import random as R
from ..utils import graphs


class BlockKernel(NamedTuple):
    init: Callable   # (key, state) -> tune
    step: Callable   # (key, state, tune, adapt) -> (state, tune)


class SamplerSpec:
    """Base class for block sampler assignments (reference Sampler ctor,
    sampler.jl:20-24)."""

    #: operate on link-transformed (unconstrained) values?
    transform: bool = False
    #: does the kernel consume (logf, grad) rather than logf?
    needs_grad: bool = False
    #: can its block hold a site as a data rank's slice (its kernels take
    #: ``coords=``: every sum over coordinates and every normal draw goes
    #: through them)?
    holds_slices: bool = False

    def __init__(self, params):
        if isinstance(params, str):
            params = (params,)
        self.params = tuple(params)

    # -- subclass hooks --------------------------------------------------
    def kernel_init(self, key, x0, logf) -> object:
        raise NotImplementedError

    def kernel_step(self, key, x, tune, logf, adapt):
        raise NotImplementedError

    # -- engine wiring ---------------------------------------------------
    def build(self, cm) -> BlockKernel:
        return self.bind(cm, self.kernel_init, self.kernel_step)

    def bind(self, cm, kernel_init, kernel_step, graphed=None) -> BlockKernel:
        """The block kernel that runs ``kernel_init(key, x0, f)`` and
        ``kernel_step(key, x, tune, f, adapt)`` on the block's flat vectors,
        ``f`` being the batched density (and gradient).

        ``graphed(density)``, given the block's density on one state,
        returns the sampler's captured inner loop (NUTS's
        ``GraphedSubtree``, ChEES's ``GraphedTrajectory``, a slice
        sampler's trip batches), which ``kernel_step`` then takes as
        ``graphed=``.  The density is ``density(x, state) -> (logf, grad)``
        for a sampler that needs gradients, else ``density(x, state) ->
        logf (C,)`` (``candidate_logf(density, state)`` is its candidate
        form).  ``f`` closes over the other blocks' state (rats' variances,
        which its Gibbs block redraws every iteration); the captured loop
        reads them from static copies, which the block step loads once
        (``load_state``), not once per leapfrog.  A sampler that can hold
        slices (``holds_slices``) gives both kernels the block's
        coordinates, ``coords=cm.block_coords(params)`` (``WHOLE`` where
        the block holds no slice).  A block whose density reads a node that
        every data rank gathers whole (``cm.block_gathers``) takes the
        state with that node's leaves' whole values (``cm.block_prepare``,
        once per step, before a captured step loads it), or gathers them in
        each density call (``cm.block_density``, which sums the gradient in
        them over the data group: one more cut of a captured body).  A
        block whose density is
        summed over a mesh's data group (``cm.block_split``) replays as
        well: its captured loop is cut at each collective
        (``utils.graphs.cut``).  ``graphed`` takes the coordinates too
        (``graphed(density, coords=...)``) where the sampler holds
        slices.  Only a block built under ``utils.graphs.disabled()`` takes
        the plain loop."""
        vpack, vunpack = cm.block_maps(self.params, self.transform)
        density = cm.block_density(self.params, self.transform,
                                   grad=self.needs_grad)
        prepare = cm.block_prepare(self.params)
        kw = ({"coords": cm.block_coords(self.params)} if self.holds_slices
              else {})

        if self.needs_grad:
            def make_f(state):
                return lambda x: density(x, state)
        else:
            def make_f(state):
                return candidate_logf(density, state)

        captured = None
        if graphed is not None and graphs.enabled():
            captured = graphed(density, **kw)

        def init(key, state):
            state = prepare(state)
            return kernel_init(key, vpack(state), make_f(state), **kw)

        def step(key, state, tune, adapt):
            st = prepare(state)
            x = vpack(st)
            if captured is None:
                x2, tune2 = kernel_step(key, x, tune, make_f(st), adapt,
                                        **kw)
            else:
                captured.load_state(st)
                x2, tune2 = kernel_step(key, x, tune, make_f(st), adapt,
                                        graphed=captured, **kw)
            return {**state, **vunpack(x2, st)}, tune2

        return BlockKernel(init, step)

    def __repr__(self):
        return f"{type(self).__name__}({list(self.params)})"


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


def metropolis_accept(key, log_ratio, x_new, x_old, fold=None):
    """Per-chain MH accept: row ``c`` of ``x_new (C, dim)`` is taken with
    probability ``exp(log_ratio[c])``; one uniform per chain, from the
    per-chain keys ``key (C, 2)`` folded with ``fold``."""
    u = R.uniform(key, (), log_ratio.dtype, fold=fold)
    return mh_select(u, log_ratio, x_new, x_old)


def mh_select(u, log_ratio, x_new, x_old):
    """``metropolis_accept`` given its uniforms ``u (C,)``, drawn before a
    captured step."""
    accept = torch.log(u) < log_ratio
    return torch.where(accept[:, None], x_new, x_old), accept


def captured(bodies, density, grad: bool = False):
    """A sampler's captured step for the engine: ``bodies(logf_of)``, where
    ``logf_of(state)`` is the block's density on the model state the
    ``Captured`` holds (``x -> (logf, grad)`` with ``grad``, else the
    candidate form of ``candidate_logf``)."""
    if grad:
        return graphs.Captured(bodies(lambda state: lambda x: density(x, state)))
    return graphs.Captured(bodies(lambda state: candidate_logf(density, state)))


def drawing(bodies, eager: bool = False):
    """The ``Captured`` of bodies that draw inside it (MISS, ABC, Gibbs):
    from the per-chain keys in its buffer ``key``, which a step loads
    before it runs.  With ``eager`` it is the plain loop, which runs the
    same bodies eagerly.  (One place that makes them, which a test
    watches.)"""
    return graphs.Captured(bodies, eager=eager)


def plain(bodies, logf):
    """The same bodies as the sampler's plain loop on ``logf``, run eagerly
    on every device."""
    return graphs.Captured(bodies(lambda state: logf), eager=True)
