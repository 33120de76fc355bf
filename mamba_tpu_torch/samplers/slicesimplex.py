"""Slice sampling within a simplex, batched over chains (reference
src/samplers/slicesimplex.jl).

Each chain draws a point from a simplex around its current value and, while
the point is rejected, shrinks the simplex toward it (shrinksimplex,
slicesimplex.jl:109-122) and draws again.  All chains shrink in lockstep: a
trip shrinks the (K, K) vertex matrices of the chains still rejecting, one
masked coordinate at a time with a batched K x K solve, draws one new point
for every chain and evaluates the batched density once.  The host syncs
once per trip, to stop when no chain is still rejecting.

Dirichlet(1, ..., 1) points are normalized standard exponentials, drawn
from uniforms.  The accepted point is divided by its sum, which is 1 to a
few units of rounding: in float32 the rounding of ``V @ xb`` would
otherwise drift off the simplex over many iterations.

Random draws per step, in order: the slice level ``(C,)``, the first
simplex's Dirichlet weights ``(C, K)``, the first point's ``(C, K)``, then
one ``(C, K)`` per shrink trip — all uniform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import BlockKernel, SamplerSpec, summed, validatesimplex


class SliceSimplexTune(NamedTuple):
    scale: torch.Tensor     # () initial simplex scale in (0, 1], shared


def slicesimplex_init(x0, scale: float = 1.0) -> SliceSimplexTune:
    """Tune for chains on the simplex ``x0 (C, K)``, each row checked
    (reference SliceSimplexVariate validator, sampler.jl:81-83)."""
    if not 0.0 < scale <= 1.0:
        raise ValueError("scale is not in (0, 1]")
    validatesimplex(x0)
    return SliceSimplexTune(scale=torch.as_tensor(scale, dtype=x0.dtype,
                                                  device=x0.device))


def _dirichlet1(gen, like):
    """Dirichlet(1, ..., 1) rows of ``like``'s shape."""
    e = -torch.log1p(-torch.rand(like.shape, generator=gen, dtype=like.dtype,
                                 device=like.device))
    return e / torch.sum(e, -1, keepdim=True)


def _solve(V, b):
    """``V^-1 b`` per chain, without the error check that waits for the
    device."""
    return torch.linalg.solve_ex(V, b[..., None]).result[..., 0]


def _first_simplex(w, x, scale):
    """Initial bounding simplexes around ``x (C, K)`` (reference
    slicesimplex.jl:98-102): vertices in the columns of ``(C, K, K)``."""
    K = x.shape[-1]
    V = torch.eye(K, dtype=x.dtype, device=x.device)
    V = torch.cat([V[:, :1], V[:, 1:] + (1.0 - scale) * (V[:, :1] - V[:, 1:])], 1)
    return V + (x - w @ V.T)[..., None]


def _shrink(V, bx, bc, cc):
    """Shrink the vertices toward the rejected point (reference
    slicesimplex.jl:109-122): for each coordinate with ``bc_i < bx_i``, pull
    every other vertex toward vertex i and solve for the barycentric
    coordinates again."""
    K = V.shape[-1]
    col = torch.arange(K, device=V.device)
    for i in range(K):
        do = bc[:, i] < bx[:, i]
        Vi = torch.where(col == i, V, V + bc[:, i, None, None] * (V[:, :, i:i + 1] - V))
        V = torch.where(do[:, None, None], Vi, V)
        bc = torch.where(do[:, None], _solve(Vi, cc), bc)
    return V


def _outside(x):
    return torch.any(x < 0.0, -1) | torch.any(x > 1.0, -1)


def slicesimplex_step(gen, x, tune: SliceSimplexTune, logf, max_iter: int = 1000):
    """One slice-simplex transition of chains on the simplex ``x (C, K)``
    (reference sample!, slicesimplex.jl:86-103).  A chain still rejecting
    after ``max_iter`` trips keeps its value."""
    C = x.shape[0]
    p0 = logf(x) + torch.log(torch.rand((C,), generator=gen, dtype=x.dtype,
                                        device=x.device))
    V = _first_simplex(_dirichlet1(gen, x), x, tune.scale)
    xb = _dirichlet1(gen, x)
    xn = (V @ xb[..., None])[..., 0]
    active = _outside(xn) | (logf(xn) < p0)
    for _ in range(max_iter):
        if not bool(active.any()):          # the one host sync of a trip
            break
        V2 = _shrink(V, _solve(V, x), xb, xn)
        xb2 = _dirichlet1(gen, x)
        a = active[:, None]
        V = torch.where(a[..., None], V2, V)
        xb = torch.where(a, xb2, xb)
        xn = torch.where(a, (V2 @ xb2[..., None])[..., 0], xn)
        active = active & (_outside(xn) | (logf(xn) < p0))
    return torch.where(active[:, None], x, xn / torch.sum(xn, -1, keepdim=True)), tune


class SliceSimplex(SamplerSpec):
    """SliceSimplex(params; scale=1.0): slice sampling for simplex-valued
    nodes, e.g. Dirichlet blocks (reference slicesimplex.jl:38-64).  Each
    node of the block gets its own shrinking-simplex pass; a node of shape
    ``(..., K)`` is a batch of K-simplexes, updated one row after another
    against the block density (reference SliceSimplex_sub!,
    slicesimplex.jl:61-79)."""

    transform = False

    def __init__(self, params, scale: float = 1.0):
        super().__init__(params)
        if not 0 < scale <= 1:
            raise ValueError("scale is not in (0, 1]")
        self.scale = float(scale)

    def build(self, cm) -> BlockKernel:
        per_site = []
        for name in self.params:
            shape = cm.sites[name].shape
            K = shape[-1] if shape else 1
            pack, unpack, _, logf = cm.block_functions((name,), False)
            per_site.append((name, K, torch.func.vmap(pack),
                             torch.func.vmap(unpack),
                             summed(torch.func.vmap(logf),
                                    cm.block_sum((name,)))))

        def init(gen, state):
            return SliceSimplexTune(scale=torch.tensor(self.scale, dtype=cm.dtype,
                                                       device=cm.device))

        def step(gen, state, tune, adapt):
            for name, K, vpack, vunpack, vlogf in per_site:
                flat = vpack(state)
                C = flat.shape[0]
                x = flat.reshape(C, -1, K)
                for r in range(x.shape[1]):
                    def f(v, x=x, r=r):
                        y = x.clone()
                        y[:, r] = v
                        return vlogf(y.reshape(C, -1), state)
                    row, _ = slicesimplex_step(gen, x[:, r], tune, f)
                    x = x.clone()
                    x[:, r] = row
                state = {**state, **vunpack(x.reshape(C, -1), state)}
            return state, tune

        return BlockKernel(init, step)
