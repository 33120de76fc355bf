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
(``-log(-log(u))`` of uniforms), at the start of the sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import BlockKernel, SamplerSpec, candidate_logf, summed


class DGSTune(NamedTuple):
    support: torch.Tensor   # (n_elem, K) candidate values (padded)
    mask: torch.Tensor      # (n_elem, K) valid-candidate mask


def dgs_support(dist, shape, dtype=torch.float64, device="cpu") -> DGSTune:
    """Support grid of a (possibly batched) discrete distribution over a
    node of ``shape``."""
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


def _gumbel(gen, shape, like):
    u = torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def dgs_step(gen, x, tune: DGSTune, logf):
    """One Gibbs sweep over the elements of ``x (C, n)``: each element is
    drawn from its exact conditional over the enumerated support."""
    C, n = x.shape
    noise = _gumbel(gen, (C, n, tune.support.shape[1]), x)
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
    """One DGS block's sweep, captured once as a CUDA graph and replayed:
    the n density calls of a sweep are thousands of small launches, and the
    replay issues them without the host.  The inputs are copied into the
    graph's own tensors before each replay; a change of their shapes
    captures again.  The kernels and their order are those of the sweep
    run eagerly, so the two give the same draws."""

    def __init__(self, sweep):
        self.sweep = sweep          # (x, noise, state) -> x'
        self.key = None

    def __call__(self, x, noise, state):
        key = (tuple(x.shape), tuple(noise.shape),
               tuple((k, tuple(v.shape)) for k, v in state.items()))
        if key != self.key:
            self._capture(x, noise, state)
            self.key = key
        self.x.copy_(x)
        self.noise.copy_(noise)
        for k, v in state.items():
            self.state[k].copy_(v)
        self.graph.replay()
        return self.out.clone()

    def _capture(self, x, noise, state):
        self.x, self.noise = x.clone(), noise.clone()
        self.state = {k: v.clone() for k, v in state.items()}
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):       # warm up before the capture
            for _ in range(2):
                self.sweep(self.x, self.noise, self.state)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.sweep(self.x, self.noise, self.state)


def discrete_step(gen, support, mass):
    """The stand-alone DiscreteVariate form (reference sample!,
    dgs.jl:129-133): one draw from the masses ``mass (..., K)`` over
    ``support (K,)`` or rows ``(K, d)``, per leading index of ``mass``."""
    mass = torch.as_tensor(mass)
    logits = torch.log(mass)
    idx = torch.argmax(logits + _gumbel(gen, logits.shape, logits), -1)
    return torch.as_tensor(support, device=mass.device)[idx]


class DGS(SamplerSpec):
    """DGS(params): exact discrete Gibbs over model nodes with finite
    support (reference DGS ctor, dgs.jl:56-84).  Support bounds are frozen
    when the block is built.  On a CUDA device the sweep is replayed from a
    CUDA graph (``GraphedSweep``), so the block density must not copy from
    the host; a sweep whose density is split over a mesh's data axis runs
    eagerly, its sum over the data group outside any graph."""

    transform = False

    def build(self, cm) -> BlockKernel:
        kernels = []
        for name in self.params:
            dist = cm.example_dists[name]
            if not getattr(dist, "is_discrete", False):
                raise ValueError(f"DGS needs a discrete node, got {name!r}")
            tune0 = dgs_support(dist, cm.sites[name].shape, cm.dtype, cm.device)
            pack, unpack, _, logf = cm.block_functions((name,), False)
            vlogf = summed(torch.func.vmap(logf), cm.block_sum((name,)))
            # a sweep whose density is summed over a data group runs its
            # collectives eagerly: they are not captured in a CUDA graph
            graphed = cm.device.type == "cuda" and not cm.block_split((name,))

            def sweep(x, noise, state, tune0=tune0, vlogf=vlogf):
                return _sweep(x, noise, tune0, candidate_logf(vlogf, state))

            kernels.append((tune0, torch.func.vmap(pack), torch.func.vmap(unpack),
                            GraphedSweep(sweep) if graphed else sweep))

        def init(gen, state):
            return tuple(k[0] for k in kernels)

        def step(gen, state, tunes, adapt):
            for tune0, vpack, vunpack, sweep in kernels:
                x = vpack(state)
                noise = _gumbel(gen, (x.shape[0], x.shape[1],
                                      tune0.support.shape[1]), x)
                state = {**state, **vunpack(sweep(x, noise, state), state)}
            return state, tunes

        return BlockKernel(init, step)
