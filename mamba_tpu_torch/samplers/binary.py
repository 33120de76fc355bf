"""Binary-state samplers, batched over chains: BHMC, BIA, BMC3, BMG
(reference src/samplers/{bhmc,bia,bmc3,bmg}.jl).

All four work on 0/1 vectors ``x (C, n)`` with a block log-density.  Where a
step needs the density at several points per chain, they go in one call on
``(C, m, n)``.

- ``BHMC``: binary Hamiltonian Monte Carlo (a particle bouncing off the
  walls of the orthants, Pakman and Paninski 2013).  Every chain moves from
  wall hit to wall hit in lockstep; a trip is one hit for every chain still
  travelling (two densities, scored in one call), and a chain that has
  travelled ``traveltime`` is left as it is.  Trips run in batches of
  ``CHECK_EVERY``, and the host tests after each batch whether any chain
  still travels (``graphs.until_done``).  The set-up with the first batch,
  and a batch, are two bodies on tensors of their own
  (``utils.graphs.Captured``): the engine replays them from CUDA graphs,
  the stand-alone step runs them eagerly.  A coordinate sitting
  on the wall it has just been taken through (or bounced off) reads a wall
  time of 0 and must not be hit again.  The JAX package guards the last wall
  hit only, by ``1e4`` float64 epsilons: when two walls are hit at the same
  instant (in float32 a few times per iteration at 1024 chains), the two
  coordinates then take turns at move time 0, gaining speed, until
  ``max_hits``.  Here every coordinate hit less than ``1e4`` epsilons of the
  state's dtype ago is guarded, which is the reference's guard whenever the
  last move took longer than that.
- ``BIA``: per-coordinate add/delete proposal probabilities adapted toward
  a target acceptance rate (bia.jl:70-119).
- ``BMC3``: flip k random coordinates (or one random group of them), MH
  accept (bmc3.jl:57-68).
- ``BMG``: Metropolised Gibbs with conditional Bernoulli proposals and the
  proposal correction when k > 1 (bmg.jl:57-104).

BIA's, BMC3's and BMG's steps are one body each, on tensors of their own
(``utils.graphs.Captured``), which the engine replays from a CUDA graph
and the stand-alone step runs eagerly; BIA's ``rate`` (``iter ** -decay``),
``epsilon`` and ``target`` are 0-d buffers, loaded before the replay.

Random draws per step, in order: BHMC — the position ``(C, n)`` and the
velocity ``(C, n)`` (normal); BIA — ``(C, n)`` then ``(C,)`` (uniform);
BMC3 — the index draw, ``(C, n)`` whose ``argsort`` picks k coordinates or
``(C,)`` that picks a group, then the acceptance ``(C,)``; BMG — the index
draw, the proposals ``(C, n)``, the acceptance ``(C,)`` (uniform; none
with one coordinate).  Every draw is made before the step's body, draw
``i`` of a step from ``fold_in(key, i)`` of the block's per-chain keys.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import random as R
from ..utils import graphs
from .base import SamplerSpec, captured, plain, validatebinary

#: BHMC trips between two host tests of whether any chain still travels; a
#: trip of a chain that has stopped changes nothing, so it only costs time
CHECK_EVERY = 8
#: wall hits after which a chain stops where it is
MAX_HITS = 10000


def _rand(key, shape, like, fold):
    """Uniforms of per-chain ``shape`` from ``fold_in(key, fold)``."""
    return R.uniform(key, shape, like.dtype, fold=fold)


def _randn(key, shape, like, fold):
    return R.normal(key, shape, like.dtype, fold=fold)


def _pair(logf, y, x):
    """``logf`` at ``y`` and at ``x``, ``(C, n)`` each, in one call."""
    lf = logf(torch.stack([y, x], 1))
    return lf[:, 0], lf[:, 1]


# ---------------------------------------------------------------------------
# BHMC
# ---------------------------------------------------------------------------

class BHMCTune(NamedTuple):
    traveltime: float
    position: torch.Tensor      # (C, n) at the end of the last trajectory
    velocity: torch.Tensor      # (C, n)
    wallhits: torch.Tensor      # (C,) int32, summed over trajectories
    wallcrosses: torch.Tensor   # (C,) int32
    #: the fields held per chain, chain axis first (a sharded run's chain
    #: file joins them over the chain ranks: ``output.fileio``)
    CHAIN_LEAVES = ("position", "velocity", "wallhits", "wallcrosses")


def bhmc_init(key, x0, traveltime) -> BHMCTune:
    validatebinary(x0)
    C = x0.shape[0]
    zeros = torch.zeros(C, dtype=torch.int32, device=x0.device)
    return BHMCTune(traveltime=float(traveltime),
                    position=_randn(key, x0.shape[1:], x0, 0),
                    velocity=_randn(key, x0.shape[1:], x0, 1),
                    wallhits=zeros, wallcrosses=zeros.clone())


def _wall_hit(b, logf, T, max_hits):
    """One wall hit (or the end of the trajectory) for every chain still
    travelling, on the trajectory's tensors ``b``; a chain stops at
    ``max_hits`` trips."""
    a, pos0, S, since, total = b["a"], b["b"], b["S"], b["since"], b["total"]
    nearzero = 1e4 * torch.finfo(a.dtype).eps
    done = b["done"] | (b["it"] >= max_hits)
    phi = torch.atan2(pos0, a)
    walltime = torch.where(phi > 0.0, math.pi - phi, -phi)
    # a wall just hit is found again at time ~0 (or ~2 pi): skip it
    guard = ((torch.abs(walltime) < nearzero)
             | (torch.abs(walltime - 2.0 * math.pi) < nearzero))
    walltime = torch.where((since < nearzero) & guard, torch.inf, walltime)
    j = torch.argmin(walltime, -1)
    onehot = b["cols"] == j[:, None]
    movetime = torch.gather(walltime, 1, j[:, None])[:, 0]
    movetime = torch.where(torch.isinf(movetime), math.pi, movetime)
    total_new = total + movetime
    fin = total_new >= T
    movetime = torch.where(fin, movetime - (total_new - T), movetime)
    c, s = torch.cos(movetime)[:, None], torch.sin(movetime)[:, None]
    vel, pos = a * c - pos0 * s, a * s + pos0 * c

    # the wall: cross it if the kinetic energy pays the density's change
    half = (S + 1.0) / 2.0
    lf1, lf0 = _pair(logf, torch.where(onehot, 1.0, half),
                     torch.where(onehot, 0.0, half))
    vj = torch.gather(vel, 1, j[:, None])[:, 0]
    v2 = vj * vj + torch.sign(vj) * 2.0 * (lf1 - lf0)
    cross = v2 > 0.0
    vel_j = torch.where(cross, torch.sqrt(torch.abs(v2)) * torch.sign(vj), -vj)

    live = ~done
    wall = live & ~fin
    w, lv = wall[:, None], live[:, None]
    b["hits"].add_(wall.to(torch.int32))
    b["crosses"].add_((wall & cross).to(torch.int32))
    b["a"].copy_(torch.where(w, torch.where(onehot, vel_j[:, None], vel),
                             torch.where(lv, vel, a)))
    b["b"].copy_(torch.where(w, torch.where(onehot, 0.0, pos),
                             torch.where(lv, pos, pos0)))
    b["S"].copy_(torch.where(w & onehot & cross[:, None], -S, S))
    b["since"].copy_(torch.where(w & onehot, 0.0,
                                 torch.where(lv, since + movetime[:, None], since)))
    b["total"].copy_(torch.where(live, total_new, total))
    b["done"].copy_(done | fin)
    b["it"].add_(1)


def _hits(b, logf, T, max_hits):
    for _ in range(CHECK_EVERY):
        _wall_hit(b, logf, T, max_hits)
    b["more"].copy_(~(b["done"] | (b["it"] >= max_hits)).all())


def _trajectory(b, logf, T, max_hits):
    """The trajectory's start from the drawn position and velocity
    normals, and its first batch of wall hits."""
    S = 2.0 * b["x"] - 1.0
    b["S"].copy_(S)
    b["b"].copy_(torch.abs(b["pos_noise"]) * S)
    b["a"].copy_(b["vel_noise"])
    b["since"].fill_(torch.inf)
    b["total"].zero_()
    b["hits"].copy_(b["hits0"])
    b["crosses"].copy_(b["crosses0"])
    b["done"].zero_()
    b["it"].zero_()
    _hits(b, logf, T, max_hits)


def hit_bodies(logf_of, traveltime, max_hits=MAX_HITS):
    """The trajectory's bodies on the density ``logf_of(state)`` (its
    candidate form scores two points per chain)."""
    return {"start": lambda b, s: _trajectory(b, logf_of(s), traveltime, max_hits),
            "more": lambda b, s: _hits(b, logf_of(s), traveltime, max_hits)}


def bhmc_step(key, x, tune: BHMCTune, logf, max_hits: int = MAX_HITS,
              graphed=None):
    """One particle trajectory of length ``traveltime`` per chain (reference
    sample!, bhmc.jl:50-122).  As in the JAX package, and unlike the
    reference (whose fixed momentum makes the chain non-ergodic), position
    and velocity are drawn afresh for every trajectory, the position on the
    current state's side of each wall.  A chain that reaches ``max_hits``
    wall hits stops where it is.  ``graphed``: the captured bodies
    (``hit_bodies`` of this ``traveltime`` and ``max_hits``), by default the
    plain loop."""
    cap = graphed or plain(functools.partial(
        hit_bodies, traveltime=tune.traveltime, max_hits=max_hits), logf)
    pos_noise = _randn(key, x.shape[1:], x, 0)
    vel_noise = _randn(key, x.shape[1:], x, 1)
    if not cap.holds("x", x):
        C, n = x.shape
        f = dict(dtype=x.dtype, device=x.device)
        counts = torch.zeros(C, dtype=torch.int32, device=x.device)
        cap.load(S=x, a=x, b=x, since=x, total=torch.zeros(C, **f),
                 hits=counts, crosses=counts,
                 done=torch.zeros(C, dtype=torch.bool, device=x.device),
                 it=torch.zeros((), dtype=torch.long, device=x.device),
                 more=torch.zeros((), dtype=torch.bool, device=x.device),
                 cols=torch.arange(n, device=x.device))
    cap.load(x=x, pos_noise=pos_noise, vel_noise=vel_noise,
             hits0=tune.wallhits, crosses0=tune.wallcrosses)
    graphs.until_done(cap, "start", "more", math.ceil(max_hits / CHECK_EVERY))
    b = cap.bufs
    x2 = (torch.sign(b["b"]) + 1.0) / 2.0
    return x2, tune._replace(position=b["b"].clone(), velocity=b["a"].clone(),
                             wallhits=b["hits"].clone(),
                             wallcrosses=b["crosses"].clone())


class BHMC(SamplerSpec):
    transform = False

    def __init__(self, params, traveltime):
        super().__init__(params)
        self.traveltime = float(traveltime)

    def build(self, cm):
        bodies = functools.partial(hit_bodies, traveltime=self.traveltime)
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bodies, density))

    def kernel_init(self, key, x0, logf):
        return bhmc_init(key, x0, self.traveltime)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        return bhmc_step(key, x, tune, logf, graphed=graphed)


# ---------------------------------------------------------------------------
# BIA
# ---------------------------------------------------------------------------

class BIATune(NamedTuple):
    A: torch.Tensor     # (C, n) add probabilities
    D: torch.Tensor     # (C, n) delete probabilities
    epsilon: float
    decay: float
    target: float
    iter: int
    #: the fields held per chain, chain axis first (a sharded run's chain
    #: file joins them over the chain ranks: ``output.fileio``)
    CHAIN_LEAVES = ("A", "D")


def bia_init(x0, A=None, D=None, epsilon=None, decay: float = 0.55,
             target: float = 0.45) -> BIATune:
    validatebinary(x0)
    n = x0.shape[1]
    f = dict(dtype=x0.dtype, device=x0.device)
    A = torch.full(x0.shape, 1.0 / n, **f) if A is None else \
        torch.as_tensor(A, **f).expand(x0.shape).clone()
    D = torch.full(x0.shape, 1.0 / n, **f) if D is None else \
        torch.as_tensor(D, **f).expand(x0.shape).clone()
    eps = 0.01 / n if epsilon is None else float(epsilon)
    if not 0.0 < eps < 0.5:
        raise ValueError("epsilon is not in (0, 0.5)")
    if not 0.5 < decay <= 1.0:
        raise ValueError("decay is not in (0.5, 1]")
    return BIATune(A=torch.clamp(A, eps * 1.001, 1 - eps * 1.001),
                   D=torch.clamp(D, eps * 1.001, 1 - eps * 1.001),
                   epsilon=eps, decay=float(decay), target=float(target), iter=0)


def _bia(b, logf):
    """The add/delete proposal, its MH test and the adaptation of ``A`` and
    ``D`` on the draws ``b["u"]`` and ``b["ua"]``; writes ``x``, ``A`` and
    ``D``.  ``rate``, ``eps`` and ``target`` are 0-d buffers."""
    x, A, D, u = b["x"], b["A"], b["D"], b["u"]
    is0 = x == 0.0
    added = (is0 & (u < A)).to(x.dtype)
    deleted = (~is0 & (u < D)).to(x.dtype)
    y = torch.where(added > 0, 1.0, torch.where(deleted > 0, 0.0, x))
    logA, logD = torch.log(A), torch.log(D)
    log_q = torch.sum(added * (logD - logA) + deleted * (logA - logD), -1)
    lfy, lfx = _pair(logf, y, x)
    alpha = torch.clamp(torch.exp(lfy - lfx + log_q), max=1.0)
    rate, eps, target = b["rate"], b["eps"], b["target"]

    def adapt_probs(P, moved):
        c = (torch.log((P - eps) / (1.0 - P - eps))
             + rate * moved * (alpha[:, None] - target))
        return (torch.exp(c) * (1.0 - eps) + eps) / (1.0 + torch.exp(c))

    A2, D2 = adapt_probs(A, added), adapt_probs(D, deleted)
    accept = b["ua"] < alpha
    x.copy_(torch.where(accept[:, None], y, x))
    A.copy_(A2)
    D.copy_(D2)


def bia_bodies(logf_of):
    """BIA's step on the density ``logf_of(state)`` (its candidate form)."""
    return {"body": lambda b, s: _bia(b, logf_of(s))}


def bia_step(key, x, tune: BIATune, logf, graphed=None):
    """Add/delete proposal and per-coordinate adaptation of every chain
    (reference sample!, bia.jl:70-119).  ``graphed``: the captured step
    (``bia_bodies``), by default the plain one."""
    cap = graphed or plain(bia_bodies, logf)
    it = tune.iter + 1
    u = _rand(key, x.shape[1:], x, 0)
    ua = _rand(key, (), x, 1)
    f = dict(dtype=x.dtype, device=x.device)
    cap.load(x=x, A=tune.A, D=tune.D, u=u, ua=ua,
             rate=torch.full((), float(it) ** -tune.decay, **f),
             eps=torch.full((), tune.epsilon, **f),
             target=torch.full((), tune.target, **f))
    cap.run()
    b = cap.bufs
    return b["x"].clone(), tune._replace(A=b["A"].clone(), D=b["D"].clone(),
                                         iter=it)


class BIA(SamplerSpec):
    transform = False

    def __init__(self, params, A=None, D=None, epsilon=None,
                 decay: float = 0.55, target: float = 0.45):
        super().__init__(params)
        self.kwargs = dict(A=A, D=D, epsilon=epsilon, decay=decay,
                           target=target)

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bia_bodies, density))

    def kernel_init(self, key, x0, logf):
        return bia_init(x0, **self.kwargs)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        return bia_step(key, x, tune, logf, graphed=graphed)


# ---------------------------------------------------------------------------
# BMC3 / BMG index selection
# ---------------------------------------------------------------------------

class IndexSelect(NamedTuple):
    """Index-selection tune shared by BMC3 and BMG: ``k`` random
    coordinates, or (``groups_mask (G, n)``) one of G fixed groups."""
    groups_mask: Optional[torch.Tensor]
    k: int = 1


BMC3Tune = BMGTune = IndexSelect


def _index_init(x0, k) -> IndexSelect:
    validatebinary(x0)
    n = x0.shape[1]
    if isinstance(k, int):
        if k > n:
            raise ValueError(f"k exceeds variate length {n}")
        return IndexSelect(groups_mask=None, k=k)
    masks = np.zeros((len(k), n), bool)
    for gi, g in enumerate(k):
        for i in g:
            if not 0 <= i < n:
                raise ValueError(f"index {i} exceeds variate length {n}")
            masks[gi, i] = True
    return IndexSelect(groups_mask=torch.as_tensor(masks, device=x0.device), k=0)


def _index_mask(b, k):
    """``(C, n)`` mask of the coordinates each chain updates, from the
    draw ``b["idx"]``: k drawn without replacement (reference randind), or
    with ``k == 0`` one of the groups ``b["groups"] (G, n)``."""
    x, u = b["x"], b["idx"]
    if k:
        order = torch.argsort(u, -1)[:, :k]
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter(
            1, order, True)
    G = b["groups"].shape[0]
    return b["groups"][torch.clamp((u * G).long(), max=G - 1)]


def _index_load(cap, key, x, tune: IndexSelect):
    """Loads ``x``, the index draw and the groups (once) into ``cap``: the
    index draw is ``(C, n)`` uniforms, whose ``argsort`` picks k
    coordinates, or ``(C,)``, which pick a group."""
    if tune.groups_mask is None:
        cap.load(x=x, idx=_rand(key, x.shape[1:], x, 0))
        return
    cap.load(x=x, idx=_rand(key, (), x, 0))
    if not cap.holds("groups", tune.groups_mask):
        cap.load(groups=tune.groups_mask)


def bmc3_init(x0, k=1) -> BMC3Tune:
    return _index_init(x0, k)


def _bmc3(b, logf, k):
    x = b["x"]
    y = torch.where(_index_mask(b, k), 1.0 - x, x)
    lfy, lfx = _pair(logf, y, x)
    accept = torch.log(b["ua"]) < lfy - lfx
    x.copy_(torch.where(accept[:, None], y, x))


def bmc3_bodies(logf_of, k):
    """BMC3's step on the density ``logf_of(state)``; ``k`` coordinates, or
    with ``k == 0`` a group."""
    return {"body": lambda b, s: _bmc3(b, logf_of(s), k)}


def bmc3_step(key, x, tune: BMC3Tune, logf, graphed=None):
    """Flip the selected coordinates, MH accept (reference bmc3.jl:57-68).
    ``graphed``: the captured step (``bmc3_bodies`` of ``tune.k``), by
    default the plain one."""
    cap = graphed or plain(functools.partial(bmc3_bodies, k=tune.k), logf)
    _index_load(cap, key, x, tune)
    cap.load(ua=_rand(key, (), x, 1))
    cap.run()
    return cap.bufs["x"].clone(), tune


def _index_k(k) -> int:
    """The bodies' ``k`` of a spec's ``k``: 0 for groups."""
    return k if isinstance(k, int) else 0


class BMC3(SamplerSpec):
    transform = False

    def __init__(self, params, k=1):
        super().__init__(params)
        self.k = k

    def build(self, cm):
        bodies = functools.partial(bmc3_bodies, k=_index_k(self.k))
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bodies, density))

    def kernel_init(self, key, x0, logf):
        return bmc3_init(x0, self.k)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        return bmc3_step(key, x, tune, logf, graphed=graphed)


# ---------------------------------------------------------------------------
# BMG
# ---------------------------------------------------------------------------

def bmg_init(x0, k=1) -> BMGTune:
    return _index_init(x0, k)


def _cond_probs(logf, z):
    """p_i = sigmoid(logf(z_i = 1) - logf(z_i = 0)) for every coordinate,
    0.5 where that is 0 or 1: the 2n points in one call."""
    C, n = z.shape
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    Z = z[:, None, :].expand(C, n, n)
    lf = logf(torch.cat([torch.where(eye, 0.0, Z), torch.where(eye, 1.0, Z)], 1))
    p = torch.sigmoid(lf[:, n:] - lf[:, :n])
    return torch.where((p > 0.0) & (p < 1.0), p, 0.5)


def _bmg(b, logf, k):
    x = b["x"]
    mask = _index_mask(b, k)
    probs_x = _cond_probs(logf, x)
    theta = (b["u"] < probs_x).to(x.dtype)
    y = torch.where(mask, theta, x)
    if x.shape[1] == 1:         # the shape's, fixed when the body is built
        x.copy_(y)
        return

    def masked_logq(probs, z):
        lq = torch.where(z == 1.0, torch.log(probs), torch.log1p(-probs))
        return torch.sum(torch.where(mask, lq, 0.0), -1)

    qy = masked_logq(probs_x, y)
    qx = masked_logq(_cond_probs(logf, y), x)
    lfy, lfx = _pair(logf, y, x)
    accept = torch.log(b["ua"]) < (lfy - qy) - (lfx - qx)
    x.copy_(torch.where(accept[:, None], y, x))


def bmg_bodies(logf_of, k):
    """BMG's step on the density ``logf_of(state)``: the conditionals at
    ``x`` (2n points), at the proposal, and the pair, three candidate
    calls; ``k`` coordinates, or with ``k == 0`` a group."""
    return {"body": lambda b, s: _bmg(b, logf_of(s), k)}


def bmg_step(key, x, tune: BMGTune, logf, graphed=None):
    """Metropolised Gibbs with conditional Bernoulli proposals (reference
    bmg.jl:57-104); with one coordinate the proposal is taken as it is.
    ``graphed``: the captured step (``bmg_bodies`` of ``tune.k``), by
    default the plain one."""
    cap = graphed or plain(functools.partial(bmg_bodies, k=tune.k), logf)
    _index_load(cap, key, x, tune)
    cap.load(u=_rand(key, x.shape[1:], x, 1))
    if x.shape[1] > 1:
        cap.load(ua=_rand(key, (), x, 2))
    cap.run()
    return cap.bufs["x"].clone(), tune


class BMG(SamplerSpec):
    transform = False

    def __init__(self, params, k=1):
        super().__init__(params)
        self.k = k

    def build(self, cm):
        bodies = functools.partial(bmg_bodies, k=_index_k(self.k))
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(bodies, density))

    def kernel_init(self, key, x0, logf):
        return bmg_init(x0, self.k)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        return bmg_step(key, x, tune, logf, graphed=graphed)
