"""No-U-Turn sampler with dual-averaging step-size adaptation, batched over
chains.

Counterpart of the JAX package's NUTS (reference src/samplers/nuts.jl,
Hoffman & Gelman 2014, Algorithm 6).  Every function here works on an
explicit chain axis: positions and momenta are ``(C, dim)``, per-chain
scalars ``(C,)``, and ``logfgrad(x) -> (logf (C,), grad (C, dim))``.

The reference's recursive ``buildtree`` (nuts.jl:139-180) is the iterative
doubling build with the checkpoint-buffer U-turn checks of Phan et al.:
even-indexed leaves are stored in a ``max_depth``-slot buffer, odd-indexed
leaves are checked against the buffered start states of every subtree they
close.  All chains build their trees in lockstep with per-chain masks: a
chain whose trajectory has stopped keeps its values while the others go on.
The host synchronizes once per doubling level (to stop when no chain is
still building), never once per leapfrog step; a level's ``2**j`` leaves
always all run, which costs only masked-out leapfrogs.

Random draws per transition, from the block's per-chain keys ``(C, 2)``
(``ops/random.py``): the momentum ``(C, dim)`` from ``fold_in(key, 0)``,
the slice uniform ``(C,)`` from ``fold_in(key, 1)``, then per doubling
level ``j`` one uniform draw ``(C, 2 + 2**j)`` from ``fold_in(key, 2 +
j)``: the direction, the acceptance uniform and the level's leaf uniforms,
leaf ``i``'s proposal choice at column ``2 + i``.  So a chain's numbers do
not depend on how deep the other chains' trees go.  Drawn before the level
runs, they let the leaf run without drawing: the stand-alone
``nuts_step`` builds a level with the plain loop ``_build_subtree`` (one
Python pass per leaf, host slot indices), and the engine with
``GraphedSubtree``, which replays one captured leaf step ``_leaf`` whose
leaf index and checkpoint slots live on the device (the JAX package's
traced ``_ckpt_idxs`` and slot loop), as the JAX engine runs the subtree as
a ``lax.while_loop``.  The two give the same draws.

On a mesh's data axis a block may hold some sites as the rank's slice
(``coords``, a ``parallel.mesh.BlockCoords``, which the engine passes): the
momentum is drawn at the rank's counters of the unsharded flat vector, and the kinetic energy, the step-size search's and the U-turn
checks' sums over coordinates are completed over the data group, so every
rank takes the same tree.  In the engine such a block replays its captured
leaf, cut at its density's all-reduce and at its sums' (``utils/graphs.py``).

The slice-variable formulation, uniform proposal selection within the
candidate set, divergence cutoff (+1000), U-turn criterion (nuts.jl:183-187)
and dual-averaging schedule (nuts.jl:63-92) match the reference; the tree
depth is capped at ``max_depth`` (default 10, as in Stan).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import random as R
from ..parallel.mesh import WHOLE
from ..utils.graphs import Captured
from .base import SamplerSpec


class NUTSTune(NamedTuple):
    """Per-chain tuning state; every field has the chain axis first."""
    epsilon: torch.Tensor
    epsilonbar: torch.Tensor
    Hbar: torch.Tensor
    mu: torch.Tensor
    m: torch.Tensor          # int32 adaptation counter
    alpha: torch.Tensor      # last doubling's accept-stat sum (diagnostics)
    nalpha: torch.Tensor
    depth: torch.Tensor      # tree depth of the last transition
    #: dual averaging has run at least once, so the frozen phase uses
    #: epsilonbar (nuts.jl:83)
    adapted: torch.Tensor
    gamma: torch.Tensor
    kappa: torch.Tensor
    t0: torch.Tensor
    target: torch.Tensor
    # diagonal mass-matrix adaptation (beyond the reference): minv is the
    # inverse mass, learned from Welford statistics over expanding warmup
    # windows.  window == 0 disables adaptation.
    minv: torch.Tensor
    w_n: torch.Tensor
    w_mean: torch.Tensor
    w_m2: torch.Tensor
    window: torch.Tensor


#: every field is held per chain (a sharded run's chain file joins them over
#: the chain ranks: ``output.fileio``)
NUTSTune.CHAIN_LEAVES = NUTSTune._fields
#: the fields held per coordinate of the block's flat vector (a data rank's
#: coordinates where the block holds slices: the file joins them into the
#: unsharded order)
NUTSTune.COORD_LEAVES = ("minv", "w_mean", "w_m2")


def _col(v):
    return v[:, None]


def _leapfrog(x, r, grad, eps, logfgrad, minv=None):
    """One leapfrog step (reference nuts.jl:129-136) with per-chain step
    ``eps (C,)``; ``minv`` is the diagonal inverse mass (None = identity)."""
    r = r + _col(0.5 * eps) * grad
    x = x + _col(eps) * (r if minv is None else minv * r)
    logf, grad = logfgrad(x)
    r = r + _col(0.5 * eps) * grad
    return x, r, logf, grad


def _kinetic(r, minv, coords=WHOLE):
    return 0.5 * coords.sum(r * r if minv is None else r * (minv * r))


def nutsepsilon(key, x, logfgrad, coords=WHOLE):
    """Initial step size per chain by doubling/halving search (reference
    nuts.jl:192-205); ``coords``: the block's coordinates on a data rank
    (module docstring)."""
    return _epsilon_search(x, coords.randn(key, x), logfgrad, coords)


def _epsilon_search(x, r0, logfgrad, coords=WHOLE):
    logf0, grad0 = logfgrad(x)
    k0 = coords.sum(r0 * r0)

    def probe(eps):
        _, rp, logfp, _ = _leapfrog(x, r0, grad0, eps, logfgrad)
        prob = torch.exp(logfp - logf0 - 0.5 * (coords.sum(rp * rp) - k0))
        # NaN (diverged probe) counts as accept-prob 0 so the search halves
        # the step instead of silently returning the current epsilon
        return torch.where(torch.isnan(prob), 0.0, prob)

    eps = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    prob = probe(eps)
    pm = torch.where(prob > 0.5, 1.0, -1.0).to(x.dtype)
    go = prob ** pm > 0.5 ** pm
    for _ in range(100):
        if not bool(go.any()):      # host sync; tune init only
            break
        eps = torch.where(go, eps * 2.0 ** pm, eps)
        prob = torch.where(go, probe(eps), prob)
        go = go & (prob ** pm > 0.5 ** pm)
    return eps


def nuts_init(key, x0, logfgrad, epsilon=None, target: float = 0.6,
              mass_window: int = 0, minv0=None, coords=WHOLE) -> NUTSTune:
    """Tune init for chains ``x0 (C, dim)`` (reference NUTSTune ctor,
    nuts.jl:22-27; epsilon search when not given, nuts.jl:29-30).
    ``minv0`` seeds the diagonal inverse mass with a posterior-variance
    estimate; with ``mass_window == 0`` it is used as-is, never
    refreshed.  ``coords``: the block's coordinates on a data rank; a
    ``minv0`` per coordinate of the unsharded flat vector is cut to
    them."""
    C = x0.shape[0]
    f = dict(dtype=x0.dtype, device=x0.device)
    i32 = dict(dtype=torch.int32, device=x0.device)
    eps = (nutsepsilon(key, x0, logfgrad, coords) if epsilon is None
           else torch.full((C,), float(epsilon), **f))
    zeros = torch.zeros(C, **f)
    window = mass_window if (mass_window or minv0 is None) else 2**30
    return NUTSTune(
        epsilon=eps, epsilonbar=torch.ones(C, **f), Hbar=zeros, mu=zeros,
        m=torch.zeros(C, **i32), alpha=zeros, nalpha=torch.zeros(C, **i32),
        depth=torch.zeros(C, **i32),
        adapted=torch.zeros(C, dtype=torch.bool, device=x0.device),
        gamma=torch.full((C,), 0.05, **f), kappa=torch.full((C,), 0.75, **f),
        t0=torch.full((C,), 10.0, **f), target=torch.full((C,), target, **f),
        minv=(torch.ones_like(x0) if minv0 is None
              else coords.cut(torch.as_tensor(minv0, **f))
              .expand(x0.shape).clone()),
        w_n=torch.zeros(C, **i32),
        w_mean=torch.zeros_like(x0), w_m2=torch.zeros_like(x0),
        window=torch.full((C,), window, **i32))


# ---------------------------------------------------------------------------
# iterative tree building
# ---------------------------------------------------------------------------

def _popcount(n: int) -> int:
    return bin(n).count("1")


def _ckpt_idxs(leaf: int):
    """Checkpoint slot range closed by ``leaf`` (see module docstring).
    ``idx_max`` = popcount(leaf >> 1); ``idx_min`` = idx_max - (trailing
    ones of leaf) + 1.  Every chain of a level is at the same leaf, so these
    are host integers."""
    idx_max = _popcount(leaf >> 1)
    trailing_ones = _popcount(leaf) - _popcount(leaf & (leaf + 1))
    return idx_max - trailing_ones + 1, idx_max


def _popcount_t(v):
    """Bits set in each element of a non-negative int32 tensor, by bit
    operations (no multiply, so nothing overflows)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _ckpt_idxs_t(leaf):
    """``_ckpt_idxs`` of each element of an int32 tensor of leaf indices:
    the JAX package's traced form, for a leaf index that lives on the
    device."""
    idx_max = _popcount_t(leaf >> 1)
    trailing_ones = _popcount_t(leaf) - _popcount_t(leaf & (leaf + 1))
    return idx_max - trailing_ones + 1, idx_max


def _turn_terms(x_ck, r_ck, x, r, pm, idx_min, idx_max, minv):
    """The U-turn check between the current (odd) leaf and every buffered
    subtree start it closes, slots ``idx_min..idx_max`` of the ``(C,
    max_depth, dim)`` buffers: the products dx * v_start and dx * v_new,
    each ``(C, slots, dim)``, with dx = pm * (x_new - x_start) oriented by
    build direction ``pm`` and v the velocity minv*r.  A chain turned iff
    either sum over the coordinates is negative (``_turned``; reference
    nouturn, nuts.jl:183-187)."""
    sl = slice(idx_min, idx_max + 1)
    dx = pm[:, None, None] * (x[:, None, :] - x_ck[:, sl])
    v_ck = r_ck[:, sl] if minv is None else minv[:, None, :] * r_ck[:, sl]
    v = r if minv is None else minv * r
    return dx * v_ck, dx * v[:, None, :]


def _turned(start, end):
    """Per chain: any slot's dot product negative."""
    return ((start < 0) | (end < 0)).any(dim=-1)


def _subtree_turned_slots(x_ck, r_ck, x, r, pm, idx_min, idx_max, minv):
    """The U-turn check (``_turn_terms``, ``_turned``) with the slot range
    as int tensors, ``(1,)`` for every chain or ``(C, 1)`` per chain: the
    check runs over all ``max_depth`` slots and masks out those outside the
    range, as the JAX package's loop over traced slots does
    (nuts.py:155-182).  ``_leaf`` takes its two halves, ``_slot_terms``
    and ``_turned_in``, around one sum with its kinetic energy."""
    return _turned_in(*WHOLE.sums(*_slot_terms(x_ck, r_ck, x, r, pm, minv)),
                      idx_min, idx_max)


def _slot_terms(x_ck, r_ck, x, r, pm, minv):
    """``_turn_terms`` against every slot of the buffers."""
    dx = pm[:, None, None] * (x[:, None, :] - x_ck)
    v_ck = r_ck if minv is None else minv[:, None, :] * r_ck
    v = r if minv is None else minv * r
    return dx * v_ck, dx * v[:, None, :]


def _turned_in(start, end, idx_min, idx_max):
    """``_turned`` over the slots ``idx_min..idx_max`` of the sums
    ``(C, max_depth)`` of ``_slot_terms``."""
    slots = torch.arange(start.shape[1], dtype=idx_max.dtype,
                         device=start.device)
    inrange = (slots >= idx_min) & (slots <= idx_max)
    return (((start < 0) | (end < 0)) & inrange).any(dim=-1)


def _build_subtree(x0, r0, grad0, pm, j, eps, logfgrad, logp0, logu0,
                   x_ck, r_ck, minv, active, us, coords=WHOLE):
    """Build ``2**j`` leapfrog steps in direction ``pm (C,)`` from end states
    (x0, r0, grad0), for the chains in ``active``; leaf ``i`` takes its
    uniform proposal draw from row ``i`` of ``us``.  Returns the new end
    states, each subtree's uniform proposal, candidate count n', validity
    s' and accept stats — the contract of the reference's recursive
    buildtree (nuts.jl:139-180).  A chain stops at the leaf that diverges
    or turns; later leaves leave it as it was.  This is the plain loop,
    one Python pass per leaf with host slot indices; the engine replays
    ``_leaf`` instead (``GraphedSubtree``), with the same results.
    ``coords``: the block's coordinates on a data rank."""
    dt = x0.dtype
    x, r, grad, xprop = x0, r0, grad0, x0
    nprime = torch.zeros_like(active, dtype=torch.int32)
    alpha = torch.zeros_like(logp0)
    nalpha = torch.zeros_like(nprime)
    sprime = active.clone()
    step = pm * eps
    for leaf in range(2 ** j):
        xn, rn, logf, gn = _leapfrog(x, r, grad, step, logfgrad, minv)
        act = sprime
        a2 = _col(act)
        x = torch.where(a2, xn, x)
        r = torch.where(a2, rn, r)
        grad = torch.where(a2, gn, grad)
        # the kinetic energy and, on an odd leaf, the U-turn checks' dot
        # products: one sum over the coordinates (one all-reduce where the
        # block holds slices)
        idx_min, idx_max = _ckpt_idxs(leaf)
        odd = leaf % 2 == 1
        kinetic, *dots = coords.sums(
            rn * rn if minv is None else rn * (minv * rn),
            *(_turn_terms(x_ck, r_ck, xn, rn, pm, idx_min, idx_max, minv)
              if odd else ()))
        logp = logf - 0.5 * kinetic
        # a diverged trajectory can hit NaN log-densities; treat as -inf so
        # the divergence machinery fires instead of NaN-poisoning the
        # accept statistics
        logp = torch.where(torch.isnan(logp), -torch.inf, logp)
        valid = act & (logu0 < logp)
        diverged = ~(logu0 < logp + 1000.0)
        nprime = nprime + valid.to(torch.int32)
        alpha = alpha + torch.where(
            act, torch.clamp(torch.exp(logp - logp0), max=1.0), 0.0)
        nalpha = nalpha + act.to(torch.int32)

        # reservoir selection = uniform draw over valid leaves (equivalent
        # to the recursion's pairwise n'2/(n'1+n'2) combines)
        take = valid & (us[leaf] * nprime.to(dt) < 1.0)
        xprop = torch.where(_col(take), xn, xprop)

        if odd:
            turned = _turned(*dots)
        else:
            x_ck[:, idx_max] = torch.where(a2, xn, x_ck[:, idx_max])
            r_ck[:, idx_max] = torch.where(a2, rn, r_ck[:, idx_max])
            turned = torch.zeros_like(act)
        sprime = sprime & ~diverged & ~turned
    return x, r, grad, xprop, nprime, sprime, alpha, nalpha


#: names of the leaf step's tensors that a level returns, in
#: ``_build_subtree``'s order
_LEAF_OUT = ("x", "r", "grad", "xprop", "nprime", "sprime", "alpha", "nalpha")


def _leaf(b, logfgrad, coords=WHOLE):
    """One leaf of ``_build_subtree`` for every chain, on the leaf step's
    tensors ``b``, which it updates in place: the leaf index ``b["leaf"]``
    ``(1,)`` lives on the device and advances by one, the leaf's uniform is
    row ``leaf`` of ``b["us"]``, its checkpoint slots are entry ``leaf`` of
    the tables ``b["ck_min"]``, ``b["ck_max"]`` (``_ckpt_idxs_t`` of every
    leaf), the checkpoint write is masked to the even leaves' active
    chains, and the U-turn check runs over every slot, masked to the range.
    No host integer and no host sync, so a CUDA graph of it serves every
    leaf of every level.  The kinetic energy and the U-turn checks' dot
    products are one sum over the block's ``coords`` (on a data rank one
    all-reduce, the leaf's second cut after its density's), on every leaf,
    so that every leaf cuts at the same places."""
    x, r, grad, minv, act = b["x"], b["r"], b["grad"], b["minv"], b["sprime"]
    leaf = b["leaf"]
    xn, rn, logf, gn = _leapfrog(x, r, grad, b["step"], logfgrad, minv)
    a2 = _col(act)
    kinetic, start, end = coords.sums(
        rn * rn if minv is None else rn * (minv * rn),
        *_slot_terms(b["x_ck"], b["r_ck"], xn, rn, b["pm"], minv))
    logp = logf - 0.5 * kinetic
    logp = torch.where(torch.isnan(logp), -torch.inf, logp)
    valid = act & (b["logu0"] < logp)
    diverged = ~(b["logu0"] < logp + 1000.0)
    nprime = b["nprime"] + valid.to(torch.int32)
    take = valid & (b["us"].index_select(0, leaf)[0] * nprime.to(x.dtype) < 1.0)

    idx_min = b["ck_min"].index_select(0, leaf)
    idx_max = b["ck_max"].index_select(0, leaf)
    even = (leaf & 1) == 0
    turned = ~even & _turned_in(start, end, idx_min, idx_max)
    sprime = act & ~diverged & ~turned

    b["alpha"].add_(torch.where(
        act, torch.clamp(torch.exp(logp - b["logp0"]), max=1.0), 0.0))
    b["nalpha"].add_(act.to(torch.int32))
    b["nprime"].copy_(nprime)
    b["xprop"].copy_(torch.where(_col(take), xn, b["xprop"]))
    # the write touches slot idx_max alone: a where over every slot would
    # move max_depth times the bytes, which a wide model (the GLMM's 10,005
    # coordinates x 1024 chains) pays on every leaf
    write = (act & even)[:, None, None]
    for ck, new in ((b["x_ck"], xn), (b["r_ck"], rn)):
        ck.index_copy_(1, idx_max, torch.where(write, new[:, None, :],
                                               ck.index_select(1, idx_max)))
    x.copy_(torch.where(a2, xn, x))
    r.copy_(torch.where(a2, rn, r))
    grad.copy_(torch.where(a2, gn, grad))
    act.copy_(sprime)
    leaf.add_(1)


def _leaf_on(density, coords, b, state):
    """``_leaf`` with the density ``density(x, state) -> (logf, grad)`` on
    the model state ``state``, summing over the block's ``coords``."""
    _leaf(b, lambda x: density(x, state), coords)


class GraphedSubtree:
    """``_build_subtree`` for the engine: ``_leaf`` captured once per run
    (``utils.graphs.Captured``) and replayed ``2**j`` times per level.  The
    density ``density(x, state) -> (logf, grad)`` reads the model state
    loaded by ``load_state`` once per block step; the level's uniforms go
    into the first ``2**j`` rows of one ``(2**max_depth, C)`` tensor, so no
    level changes a shape.  Takes the arguments of ``_build_subtree`` and
    returns the same values; it does not use ``logfgrad``, ``x_ck`` or
    ``r_ck``: the leaf step keeps its own checkpoint slots, which every
    level writes before it reads them.  ``coords``: the block's
    coordinates on a data rank, whose sums the leaf takes."""

    def __init__(self, density, max_depth: int, coords=WHOLE):
        self.max_depth = max_depth
        # the body holds the density, not this object: no reference cycle,
        # so the graph goes when the kernel does
        self.cap = Captured(functools.partial(_leaf_on, density, coords))

    def load_state(self, state):
        self.cap.load_state(state)

    def __call__(self, x0, r0, grad0, pm, j, eps, logfgrad, logp0, logu0,
                 x_ck, r_ck, minv, active, us):
        cap = self.cap
        C, dim = x0.shape
        held = cap.bufs.get("x_ck")
        if (held is None or held.shape != (C, self.max_depth, dim)
                or held.dtype != x0.dtype or held.device != x0.device):
            leaves = torch.arange(2 ** self.max_depth, dtype=torch.int32,
                                  device=x0.device)
            ck_min, ck_max = _ckpt_idxs_t(leaves)
            ck = x0.new_zeros(C, self.max_depth, dim)
            cap.load(us=us.new_zeros(2 ** self.max_depth, C),
                     ck_min=ck_min.long(), ck_max=ck_max.long(), x_ck=ck,
                     r_ck=ck)
        cap.bufs["us"][: us.shape[0]].copy_(us)
        zeros = torch.zeros_like(active, dtype=torch.int32)
        cap.load(x=x0, r=r0, grad=grad0, xprop=x0, nprime=zeros,
                 sprime=active, alpha=torch.zeros_like(logp0), nalpha=zeros,
                 step=pm * eps, pm=pm, logp0=logp0, logu0=logu0, minv=minv,
                 leaf=torch.zeros(1, dtype=torch.int32, device=x0.device))
        cap.run(2 ** j)
        return tuple(cap.bufs[k].clone() for k in _LEAF_OUT)


def nuts_sub(key, x, epsilon, logfgrad, max_depth=10, minv=None,
             subtree=None, coords=WHOLE):
    """One NUTS transition per chain at fixed step sizes ``epsilon (C,)``
    (reference nuts_sub!, nuts.jl:95-126).  With ``minv``, momenta are drawn
    from N(0, M) and the dynamics use the diagonal metric.  ``subtree``
    builds each level (``_build_subtree``'s contract; by default that plain
    loop, given ``coords``, the block's coordinates on a data rank).
    Returns the new positions and each chain's accept stats and tree
    depth."""
    C, dim = x.shape
    f = dict(dtype=x.dtype, device=x.device)
    build = subtree or functools.partial(_build_subtree, coords=coords)
    if minv is None:
        minv = torch.ones_like(x)
    r0 = coords.randn(key, x, fold=0) / torch.sqrt(minv)
    logf0, grad0 = logfgrad(x)
    logp0 = logf0 - _kinetic(r0, minv, coords)
    logu0 = logp0 + torch.log(R.uniform(key, (), x.dtype, fold=1))

    x_ck = torch.zeros(C, max_depth, dim, **f)
    r_ck = torch.zeros(C, max_depth, dim, **f)
    xm, rm, gm = x, r0, grad0
    xp, rp, gp = x, r0, grad0
    xcur = x
    n = torch.ones(C, dtype=torch.int32, device=x.device)
    s = torch.ones(C, dtype=torch.bool, device=x.device)
    alpha = torch.ones(C, **f)
    nalpha = torch.ones_like(n)
    depth = torch.zeros_like(n)
    for j in range(max_depth):
        if not bool(s.any()):       # the one host sync of a doubling level
            break
        u = R.uniform(key, (2 + 2 ** j,), x.dtype, fold=2 + j)
        pm = torch.where(u[:, 0] > 0.5, 1.0, -1.0).to(x.dtype)
        u_acc = u[:, 1]
        us = u[:, 2:].T
        left = _col(pm < 0)
        (x_new, r_new, g_new, xprop, nprime, sprime, alpha2, nalpha2
         ) = build(torch.where(left, xm, xp), torch.where(left, rm, rp),
                   torch.where(left, gm, gp), pm, j, epsilon, logfgrad, logp0,
                   logu0, x_ck, r_ck, minv, s, us)
        upd_m = _col(s) & left
        upd_p = _col(s) & ~left
        xm, rm, gm = (torch.where(upd_m, new, old) for new, old in
                      ((x_new, xm), (r_new, rm), (g_new, gm)))
        xp, rp, gp = (torch.where(upd_p, new, old) for new, old in
                      ((x_new, xp), (r_new, rp), (g_new, gp)))

        accept = s & sprime & (u_acc * n.to(x.dtype) < nprime.to(x.dtype))
        xcur = torch.where(_col(accept), xprop, xcur)
        n = torch.where(s, n + nprime, n)
        xdiff = xp - xm
        at_m, at_p = coords.sums(xdiff * (minv * rm), xdiff * (minv * rp))
        no_turn = (at_m >= 0) & (at_p >= 0)
        alpha = torch.where(s, alpha2, alpha)
        nalpha = torch.where(s, nalpha2, nalpha)
        depth = depth + s.to(torch.int32)
        s = s & sprime & no_turn
    return xcur, alpha, nalpha, depth


def nuts_step(key, x, tune: NUTSTune, logfgrad, adapt: bool, max_depth=10,
              subtree=None, coords=WHOLE):
    """NUTS transition + dual-averaging update for every chain (reference
    sample!, nuts.jl:63-92).  ``adapt`` is the warmup flag; ``subtree``
    builds each doubling level and ``coords`` are the block's coordinates
    on a data rank (``nuts_sub``)."""
    dt = x.dtype
    if adapt:
        # setadapt!: entering adaptation at m == 0 fixes mu = log(10 eps)
        mu = torch.where(tune.m == 0, torch.log(10.0 * tune.epsilon), tune.mu)
        eps_used = tune.epsilon
    else:
        # the frozen phase uses epsilonbar once adaptation has ever run
        # (nuts.jl:83), even when a mass refresh just reset m to 0
        mu = tune.mu
        eps_used = torch.where(tune.adapted, tune.epsilonbar, tune.epsilon)

    use_mass = tune.window > 0
    minv = torch.where(_col(use_mass), tune.minv, torch.ones_like(tune.minv))
    x2, alpha, nalpha, depth = nuts_sub(key, x, eps_used, logfgrad,
                                        max_depth, minv=minv, subtree=subtree,
                                        coords=coords)
    if not adapt:
        return x2, tune._replace(epsilon=eps_used, alpha=alpha,
                                 nalpha=nalpha, depth=depth)

    # Welford update + windowed inverse-mass refresh, Stan-style EXPANDING
    # windows: each refresh doubles the next window, so the final (long)
    # window — after init transients have died — decides the mass used for
    # sampling.
    w_n = tune.w_n + use_mass.to(torch.int32)
    dw = _col(use_mass)
    delta = x2 - tune.w_mean
    w_mean = torch.where(dw, tune.w_mean + delta / _col(torch.clamp(w_n, min=1)),
                         tune.w_mean)
    w_m2 = torch.where(dw, tune.w_m2 + delta * (x2 - w_mean), tune.w_m2)
    at_window = use_mass & (w_n >= tune.window)
    aw = _col(at_window)
    nw = _col(torch.clamp(w_n, min=2).to(dt))
    var = w_m2 / (nw - 1.0)
    var_reg = (nw / (nw + 5.0)) * var + 1e-3 * (5.0 / (nw + 5.0))
    minv_new = torch.where(aw, var_reg, tune.minv)
    w_n = torch.where(at_window, 0, w_n)
    w_mean = torch.where(aw, 0.0, w_mean)
    w_m2 = torch.where(aw, 0.0, w_m2)
    window = torch.where(at_window, tune.window * 2, tune.window)

    m = tune.m + 1
    mf = m.to(dt)
    p = 1.0 / (mf + tune.t0)
    Hbar = (1.0 - p) * tune.Hbar + p * (
        tune.target - alpha / torch.clamp(nalpha, min=1).to(dt))
    eps_new = torch.exp(mu - torch.sqrt(mf) * Hbar / tune.gamma)
    p2 = mf ** -tune.kappa
    epsbar = torch.exp(p2 * torch.log(eps_new)
                       + (1.0 - p2) * torch.log(tune.epsilonbar))

    # a metric change invalidates the step-size statistics: re-center dual
    # averaging on the current step and restart its counter, so the next
    # window re-adapts with full early-iteration gain
    Hbar = torch.where(at_window, 0.0, Hbar)
    mu = torch.where(at_window, torch.log(10.0 * eps_new), mu)
    m = torch.where(at_window, 0, m)

    return x2, tune._replace(
        epsilon=eps_new, epsilonbar=epsbar, Hbar=Hbar, mu=mu, m=m,
        alpha=alpha, nalpha=nalpha, depth=depth,
        adapted=torch.ones_like(tune.adapted), minv=minv_new, w_n=w_n,
        w_mean=w_mean, w_m2=w_m2, window=window)


class NUTS(SamplerSpec):
    """NUTS(params; epsilon=None, target=0.6, max_depth=10,
    mass_window=0, minv0=None) — adapts during burnin, frozen step size
    after (reference NUTS ctor nuts.jl:47-56).

    ``mass_window > 0`` additionally learns a diagonal mass matrix over
    warmup windows, the FIRST of that many iterations and each subsequent
    window twice as long (Stan-style expanding schedule).  ``minv0`` seeds
    the inverse mass in the block's unconstrained ravel order; with
    ``mass_window=0`` the seed is used as-is and never refreshed."""

    transform = True
    needs_grad = True
    holds_slices = True

    def __init__(self, params, epsilon=None, target: float = 0.6,
                 max_depth: int = 10, mass_window: int = 0, minv0=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.target = float(target)
        self.max_depth = int(max_depth)
        self.mass_window = int(mass_window)
        self.minv0 = minv0

    def kernel_init(self, key, x0, logfgrad, coords=WHOLE):
        return nuts_init(key, x0, logfgrad, epsilon=self.epsilon,
                         target=self.target, mass_window=self.mass_window,
                         minv0=self.minv0, coords=coords)

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density, coords=WHOLE: GraphedSubtree(
                             density, self.max_depth, coords))

    def kernel_step(self, key, x, tune, logfgrad, adapt, graphed=None,
                    coords=WHOLE):
        return nuts_step(key, x, tune, logfgrad, adapt, self.max_depth,
                         subtree=graphed, coords=coords)
