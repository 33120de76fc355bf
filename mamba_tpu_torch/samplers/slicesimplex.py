"""Slice sampling within a simplex, batched over chains (reference
src/samplers/slicesimplex.jl).

Each chain draws a point from a simplex around its current value and, while
the point is rejected, shrinks the simplex toward it (shrinksimplex,
slicesimplex.jl:109-122) and draws again.  All chains shrink in lockstep: a
trip shrinks the (K, K) vertex matrices of the chains still rejecting, one
masked coordinate at a time with a batched K x K solve, draws one new point
for every chain and evaluates the batched density once.  Trips run in
batches of ``TRIPS``, and the host tests once per batch whether any chain is
still rejecting (``graphs.until_done``); run eagerly, a batch ends at the
first trip that finds none (``graphs.idle``).

A node of shape ``(..., K)`` is a batch of rows, each a K-simplex, updated
one after another.  The step is two bodies on tensors of their own
(``utils.graphs.Captured``): a row's set-up (slice level, first simplex and
point, their density) with its first batch of trips, and a batch of trips
after it; the row index lives on the device, so that one graph serves
every row.  The engine replays them from CUDA graphs, the stand-alone step
runs them eagerly on its one row.

Dirichlet(1, ..., 1) points are normalized standard exponentials, drawn
from uniforms.  The accepted point is divided by its sum, which is 1 to a
few units of rounding: in float32 the rounding of ``V @ xb`` would
otherwise drift off the simplex over many iterations.

Random draws per step of a node of R rows, all uniform, from the block's
per-chain keys (one split off per node) folded with a number that names
the draw: the slice levels ``(R, C)`` (fold 0), every row's first batch
``(R, TRIPS + 2, C, K)`` (fold 1; the first simplex's Dirichlet weights,
the first point's, one point per trip), then row ``r``'s further batch
``j`` ``(TRIPS, C, K)`` (fold ``2 + r * batches + j``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..ops import random as rnd
from ..utils import graphs
from .base import (BlockKernel, SamplerSpec, candidate_logf, plain,
                   validatesimplex)

#: simplex trips per batch of a captured step, between two host tests: of
#: the lengths 8, 12, 16 and 24, 8 gave the shortest wall on asthma and
#: eyes.  The deepest of 1024 chains needs ~30 trips on asthma's rows, so
#: a row takes several batches at any of them (PERF.md §6,
#: ``scripts/trips_sweep.py``)
TRIPS = 8
#: trips after which a chain still rejecting keeps its value
MAX_ITER = 1000


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


def _dirichlet1(u):
    """Dirichlet(1, ..., 1) rows from the uniforms ``u``."""
    e = -torch.log1p(-u)
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


def _trip(b, f, u, max_iter):
    """One shrink trip of the row for every chain still rejecting that has
    made fewer than ``max_iter`` trips, on the uniforms ``u (C, K)``."""
    active, V, xb, xn = b["active"], b["V"], b["xb"], b["xn"]
    go = active & (b["trips"] < max_iter)
    V2 = _shrink(V, _solve(V, b["xr"]), xb, xn)
    xb2 = _dirichlet1(u)
    a = go[:, None]
    xn2 = torch.where(a, (V2 @ xb2[..., None])[..., 0], xn)
    b["V"].copy_(torch.where(a[..., None], V2, V))
    b["xb"].copy_(torch.where(a, xb2, xb))
    b["xn"].copy_(xn2)
    b["active"].copy_(torch.where(go, _outside(xn2) | (f(xn2) < b["p0"]), active))
    b["trips"].add_(go.to(torch.int32))


def _batch(b, f, us, max_iter):
    """Trips on the rows of ``us``, then the row's value as it stands: the
    point accepted, divided by its sum, or the entry value."""
    for k in range(us.shape[0]):
        if graphs.idle(b["active"] & (b["trips"] < max_iter)):
            break
        _trip(b, f, us[k], max_iter)
    active, xn = b["active"], b["xn"]
    row = torch.where(active[:, None], b["xr"], xn / torch.sum(xn, -1, keepdim=True))
    b["x"].copy_(torch.where(b["rowmask"], row[:, None], b["x"]))
    b["more"].copy_((active & (b["trips"] < max_iter)).any())


def _row_logf(b, logf):
    """The density of a candidate for the row, the other rows as they are."""
    x = b["x"]
    return lambda v: logf(torch.where(b["rowmask"], v[:, None], x).reshape(
        x.shape[0], -1))


def _row(b, logf, max_iter):
    """The next row's set-up and its first batch of trips."""
    b["row"].add_(1)
    r, x = b["row"], b["x"]
    b["rowmask"].copy_((b["rows"] == r)[:, None])
    f = _row_logf(b, logf)
    u = b["u"].index_select(0, r)[0]             # (TRIPS + 2, C, K)
    xr = x.index_select(1, r)[:, 0]
    p0 = f(xr) + torch.log(b["level"].index_select(0, r)[0])
    V = _first_simplex(_dirichlet1(u[0]), xr, b["scale"])
    xb = _dirichlet1(u[1])
    xn = (V @ xb[..., None])[..., 0]
    b["xr"].copy_(xr)
    b["p0"].copy_(p0)
    b["V"].copy_(V)
    b["xb"].copy_(xb)
    b["xn"].copy_(xn)
    b["active"].copy_(_outside(xn) | (f(xn) < p0))
    b["trips"].zero_()
    _batch(b, f, u[2:], max_iter)


def simplex_bodies(logf_of, max_iter: int = MAX_ITER):
    """The step's bodies on the density of the node ``logf_of(state)``,
    which takes the node's rows flattened, ``(C, R * K)``."""
    return {"row": lambda b, s: _row(b, logf_of(s), max_iter),
            "more": lambda b, s: _batch(b, _row_logf(b, logf_of(s)), b["ut"],
                                        max_iter)}


def _rows_step(key, x, scale, cap, max_iter):
    """One slice-simplex transition of every row of ``x (C, R, K)``, one
    row after another, with the bodies ``cap``; returns the new rows."""
    C, R, K = x.shape
    f = dict(dtype=x.dtype, device=x.device)
    level = rnd.uniform(key, (R,), x.dtype, fold=0).T
    u = rnd.uniform(key, (R, TRIPS + 2, K), x.dtype, fold=1).permute(1, 2, 0, 3)
    if not cap.holds("x", x):
        zeros = torch.zeros(C, **f)
        rows = torch.zeros((C, K), **f)
        cap.load(xr=rows, xb=rows, xn=rows, p0=zeros,
                 V=torch.zeros((C, K, K), **f),
                 active=torch.zeros(C, dtype=torch.bool, device=x.device),
                 trips=torch.zeros(C, dtype=torch.int32, device=x.device),
                 more=torch.zeros((), dtype=torch.bool, device=x.device),
                 row=torch.zeros(1, dtype=torch.long, device=x.device),
                 rows=torch.arange(R, device=x.device),
                 rowmask=torch.zeros((R, 1), dtype=torch.bool, device=x.device),
                 ut=torch.zeros((TRIPS, C, K), **f))
    cap.load(x=x, scale=scale, level=level, u=u)
    cap.bufs["row"].fill_(-1)

    batches = math.ceil(max_iter / TRIPS)
    for r in range(R):
        def draw(j, r=r):
            cap.bufs["ut"].copy_(rnd.uniform(
                key, (TRIPS, K), x.dtype, fold=2 + r * batches + j).transpose(0, 1))

        graphs.until_done(cap, "row", "more", batches, draw)
    return cap.bufs["x"].clone()


def slicesimplex_step(key, x, tune: SliceSimplexTune, logf,
                      max_iter: int = MAX_ITER):
    """One slice-simplex transition of chains on the simplex ``x (C, K)``
    (reference sample!, slicesimplex.jl:86-103).  A chain still rejecting
    after ``max_iter`` trips keeps its value."""
    cap = plain(functools.partial(simplex_bodies, max_iter=max_iter), logf)
    return _rows_step(key, x[:, None], tune.scale, cap, max_iter)[:, 0], tune


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
            pack, unpack, _, _ = cm.block_functions((name,), False)
            density = cm.block_density((name,), False)
            bodies = simplex_bodies(lambda state, density=density:
                                    candidate_logf(density, state))
            per_site.append((K, torch.func.vmap(pack), torch.func.vmap(unpack),
                             graphs.Captured(bodies,
                                             eager=not graphs.enabled()),
                             cm.block_prepare((name,))))

        def init(key, state):
            return SliceSimplexTune(scale=torch.tensor(self.scale, dtype=cm.dtype,
                                                       device=cm.device))

        def step(key, state, tune, adapt):
            for (K, vpack, vunpack, cap, prepare), k in zip(
                    per_site, rnd.split(key, len(per_site))):
                flat = vpack(state)
                C = flat.shape[0]
                cap.load_state(prepare(state))
                x = _rows_step(k, flat.reshape(C, -1, K), tune.scale, cap,
                               MAX_ITER)
                state = {**state, **vunpack(x.reshape(C, -1), state)}
            return state, tune

        return BlockKernel(init, step)
