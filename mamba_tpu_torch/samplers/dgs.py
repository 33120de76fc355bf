"""Discrete Gibbs sampler: exact full-conditional draws over finite supports,
batched over chains (reference src/samplers/dgs.jl).

The reference enumerates each element's support on every call
(dgs.jl:109-126); here, as in the JAX package, the support grid is resolved
once at build time from the compiled model's example distribution, padded
to the widest element's support with a mask.  The sweep visits the elements
one after another (the reference's sequential Gibbs order); an element's K
candidate values are scored for every chain in one batched density call,
``logf`` on ``(C, K, n)``, and the pick is a Gumbel-max draw.  When every
candidate of a chain is -inf the draw is uniform over the valid support,
the reference's ``psum <= 0`` branch (dgs.jl:118-122).  No host sync; on
a CUDA device the engine replays the sweep from a CUDA graph.

Random draws per step: the Gumbel noise of every element, ``(C, n, K)``
(``-log(-log(u))`` of uniforms), at the start of the sweep, from the
block's per-chain keys (one split off per node in the engine).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import random as R
from ..ops.distributions.base import param_like
from ..utils import graphs
from .base import BlockKernel, SamplerSpec, candidate_logf


class DGSTune(NamedTuple):
    support: torch.Tensor   # (n_elem, K) candidate values (padded)
    mask: torch.Tensor      # (n_elem, K) valid-candidate mask


def dgs_support(dist, shape, dtype=torch.float64, device=None) -> DGSTune:
    """Support grid of a (possibly batched) discrete distribution over a
    node of ``shape``, on ``device``: by default the device of the
    distribution's parameters, the model's."""
    if device is None:
        device = param_like(dist).device
    lo, hi = (np.broadcast_to(np.asarray(torch.as_tensor(b).detach().cpu(),
                                         dtype=float), shape).reshape(-1)
              for b in dist.support_bounds())
    if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
        raise ValueError("DGS requires finite supports (got unbounded)")
    lo, hi = lo.astype(np.int64), hi.astype(np.int64)
    K = int((hi - lo).max()) + 1
    grid = lo[:, None] + np.arange(K)[None, :]
    return DGSTune(support=torch.as_tensor(grid, dtype=dtype, device=device),
                   mask=torch.as_tensor(grid <= hi[:, None], device=device))


def _gumbel(key, shape, like):
    """Gumbel noise of per-key ``shape`` from the keys ``key``."""
    u = R.uniform(key, shape, like.dtype)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def dgs_step(key, x, tune: DGSTune, logf):
    """One Gibbs sweep over the elements of ``x (C, n)``: each element is
    drawn from its exact conditional over the enumerated support."""
    n = x.shape[1]
    noise = _gumbel(key, (n, tune.support.shape[1]), x)
    return _sweep(x, noise, tune, logf), tune


def _sweep(x, noise, tune: DGSTune, logf):
    """The sweep given its Gumbel noise ``(C, n, K)``: no draw, no host
    sync."""
    n = x.shape[1]
    support = tune.support.to(x.dtype)
    valid = torch.where(tune.mask, 0.0, -torch.inf).to(x.dtype)
    onehot = torch.eye(n, dtype=torch.bool, device=x.device)
    for i in range(n):
        cands = support[i]
        X = torch.where(onehot[i], cands[:, None], x[:, None, :])
        logmass = torch.where(tune.mask[i], logf(X), -torch.inf)
        degenerate = torch.amax(logmass, -1, keepdim=True) == -torch.inf
        logits = torch.where(degenerate, valid[i], logmass)
        pick = torch.argmax(logits + noise[:, i], -1)
        x = torch.where(onehot[i], cands[pick][:, None], x)
    return x


class GraphedSweep:
    """One DGS block's sweep, captured once as a CUDA graph and replayed
    (``utils.graphs.Captured``): the n density calls of a sweep are
    thousands of small launches, and the replay issues them without the
    host.  The inputs are copied into the graph's own tensors before each
    replay; a change of their shapes captures again.  The kernels and their
    order are those of the sweep run eagerly, so the two give the same
    draws."""

    def __init__(self, sweep):
        # sweep(x, noise, state) -> x'
        self.cap = graphs.Captured(
            lambda b, state: sweep(b["x"], b["noise"], state))

    def __call__(self, x, noise, state):
        self.cap.load(x=x, noise=noise)
        self.cap.load_state(state)
        return self.cap.run().clone()


def discrete_step(key, support, mass):
    """The stand-alone DiscreteVariate form (reference sample!,
    dgs.jl:129-133): one draw from the masses ``mass (..., K)`` over
    ``support (K,)`` or rows ``(K, d)``, per leading index of ``mass``."""
    mass = torch.as_tensor(mass)
    logits = torch.log(mass)
    idx = torch.argmax(logits + _gumbel(key, logits.shape[key.dim() - 1:],
                                        logits), -1)
    return torch.as_tensor(support, device=mass.device)[idx]


class DGS(SamplerSpec):
    """DGS(params): exact discrete Gibbs over model nodes with finite
    support (reference DGS ctor, dgs.jl:56-84).  Support bounds are frozen
    when the block is built.  On a CUDA device the sweep is replayed from a
    CUDA graph (``GraphedSweep``), so the block density must not copy from
    the host; a sweep whose density is split over a mesh's data axis is
    cut at each density call's sum over the data group, which runs between
    the segments' replays (``utils.graphs.cut``)."""

    transform = False

    def build(self, cm) -> BlockKernel:
        kernels = []
        for name in self.params:
            dist = cm.example_dists[name]
            if not getattr(dist, "is_discrete", False):
                raise ValueError(f"DGS needs a discrete node, got {name!r}")
            tune0 = dgs_support(dist, cm.sites[name].shape, cm.dtype, cm.device)
            pack, unpack, _, _ = cm.block_functions((name,), False)
            vlogf = cm.block_density((name,), False)
            graphed = cm.device.type == "cuda" and graphs.enabled()

            def sweep(x, noise, state, tune0=tune0, vlogf=vlogf):
                return _sweep(x, noise, tune0, candidate_logf(vlogf, state))

            kernels.append((tune0, torch.func.vmap(pack), torch.func.vmap(unpack),
                            GraphedSweep(sweep) if graphed else sweep,
                            cm.block_prepare((name,))))

        def init(key, state):
            return tuple(k[0] for k in kernels)

        def step(key, state, tunes, adapt):
            for (tune0, vpack, vunpack, sweep, prepare), k in zip(
                    kernels, R.split(key, len(kernels))):
                x = vpack(state)
                noise = _gumbel(k, (x.shape[1], tune0.support.shape[1]), x)
                state = {**state, **vunpack(sweep(x, noise, prepare(state)),
                                            state)}
            return state, tunes

        return BlockKernel(init, step)
