"""Binary-state samplers, batched over chains: BHMC, BIA, BMC3, BMG
(reference src/samplers/{bhmc,bia,bmc3,bmg}.jl).

All four work on 0/1 vectors ``x (C, n)`` with a block log-density.  Where a
step needs the density at several points per chain, they go in one call on
``(C, m, n)``.

- ``BHMC``: binary Hamiltonian Monte Carlo (a particle bouncing off the
  walls of the orthants, Pakman and Paninski 2013).  Every chain moves from
  wall hit to wall hit in lockstep; a trip is one hit for every chain still
  travelling (two densities, scored in one call), and a chain that has
  travelled ``traveltime`` is left as it is.  The host tests whether any
  chain still travels every ``CHECK_EVERY`` trips.  A coordinate sitting
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

Random draws per step, in order: BHMC — the position ``(C, n)`` and the
velocity ``(C, n)`` (normal); BIA — ``(C, n)`` then ``(C,)`` (uniform);
BMC3 — the index draw, ``(C, n)`` whose ``argsort`` picks k coordinates or
``(C,)`` that picks a group, then the acceptance ``(C,)``; BMG — the index
draw, the proposals ``(C, n)``, the acceptance ``(C,)`` (uniform).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .base import SamplerSpec, validatebinary

#: BHMC trips between two host tests of whether any chain still travels; a
#: trip of a chain that has stopped changes nothing, so it only costs time
CHECK_EVERY = 8


def _rand(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)


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


def bhmc_init(gen, x0, traveltime) -> BHMCTune:
    validatebinary(x0)
    C = x0.shape[0]
    zeros = torch.zeros(C, dtype=torch.int32, device=x0.device)
    return BHMCTune(traveltime=float(traveltime),
                    position=_randn(gen, x0.shape, x0),
                    velocity=_randn(gen, x0.shape, x0),
                    wallhits=zeros, wallcrosses=zeros.clone())


def bhmc_step(gen, x, tune: BHMCTune, logf, max_hits: int = 10000):
    """One particle trajectory of length ``traveltime`` per chain (reference
    sample!, bhmc.jl:50-122).  As in the JAX package, and unlike the
    reference (whose fixed momentum makes the chain non-ergodic), position
    and velocity are drawn afresh for every trajectory, the position on the
    current state's side of each wall.  A chain that reaches ``max_hits``
    wall hits stops where it is."""
    C, n = x.shape
    T = tune.traveltime
    nearzero = 1e4 * torch.finfo(x.dtype).eps
    S = 2.0 * x - 1.0
    b = torch.abs(_randn(gen, x.shape, x)) * S         # position
    a = _randn(gen, x.shape, x)                         # velocity
    cols = torch.arange(n, device=x.device)
    # time since each coordinate's last wall hit
    since = torch.full(x.shape, torch.inf, dtype=x.dtype, device=x.device)
    total = torch.zeros(C, dtype=x.dtype, device=x.device)
    hits, crosses = tune.wallhits.clone(), tune.wallcrosses.clone()
    done = torch.zeros(C, dtype=torch.bool, device=x.device)
    for it in range(max_hits):
        if it % CHECK_EVERY == 0 and bool(done.all()):
            break
        phi = torch.atan2(b, a)
        walltime = torch.where(phi > 0.0, math.pi - phi, -phi)
        # a wall just hit is found again at time ~0 (or ~2 pi): skip it
        guard = ((torch.abs(walltime) < nearzero)
                 | (torch.abs(walltime - 2.0 * math.pi) < nearzero))
        walltime = torch.where((since < nearzero) & guard, torch.inf, walltime)
        j = torch.argmin(walltime, -1)
        onehot = cols == j[:, None]
        movetime = torch.gather(walltime, 1, j[:, None])[:, 0]
        movetime = torch.where(torch.isinf(movetime), math.pi, movetime)
        total_new = total + movetime
        fin = total_new >= T
        movetime = torch.where(fin, movetime - (total_new - T), movetime)
        c, s = torch.cos(movetime)[:, None], torch.sin(movetime)[:, None]
        vel, pos = a * c - b * s, a * s + b * c

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
        hits = hits + wall.to(torch.int32)
        crosses = crosses + (wall & cross).to(torch.int32)
        w, lv = wall[:, None], live[:, None]
        a = torch.where(w, torch.where(onehot, vel_j[:, None], vel),
                        torch.where(lv, vel, a))
        b = torch.where(w, torch.where(onehot, 0.0, pos), torch.where(lv, pos, b))
        S = torch.where(w & onehot & cross[:, None], -S, S)
        since = torch.where(w & onehot, 0.0,
                            torch.where(lv, since + movetime[:, None], since))
        total = torch.where(live, total_new, total)
        done = done | fin
    x2 = (torch.sign(b) + 1.0) / 2.0
    return x2, tune._replace(position=b, velocity=a, wallhits=hits,
                             wallcrosses=crosses)


class BHMC(SamplerSpec):
    transform = False

    def __init__(self, params, traveltime):
        super().__init__(params)
        self.traveltime = float(traveltime)

    def kernel_init(self, gen, x0, logf):
        return bhmc_init(gen, x0, self.traveltime)

    def kernel_step(self, gen, x, tune, logf, adapt):
        return bhmc_step(gen, x, tune, logf)


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


def bia_step(gen, x, tune: BIATune, logf):
    """Add/delete proposal and per-coordinate adaptation of every chain
    (reference sample!, bia.jl:70-119)."""
    u = _rand(gen, x.shape, x)
    it = tune.iter + 1
    is0 = x == 0.0
    added = (is0 & (u < tune.A)).to(x.dtype)
    deleted = (~is0 & (u < tune.D)).to(x.dtype)
    y = torch.where(added > 0, 1.0, torch.where(deleted > 0, 0.0, x))
    logA, logD = torch.log(tune.A), torch.log(tune.D)
    log_q = torch.sum(added * (logD - logA) + deleted * (logA - logD), -1)
    lfy, lfx = _pair(logf, y, x)
    alpha = torch.clamp(torch.exp(lfy - lfx + log_q), max=1.0)

    rate = float(it) ** -tune.decay
    eps = tune.epsilon

    def adapt_probs(P, moved):
        c = (torch.log((P - eps) / (1.0 - P - eps))
             + rate * moved * (alpha[:, None] - tune.target))
        return (torch.exp(c) * (1.0 - eps) + eps) / (1.0 + torch.exp(c))

    A, D = adapt_probs(tune.A, added), adapt_probs(tune.D, deleted)
    accept = _rand(gen, alpha.shape, x) < alpha
    return (torch.where(accept[:, None], y, x),
            tune._replace(A=A, D=D, iter=it))


class BIA(SamplerSpec):
    transform = False

    def __init__(self, params, A=None, D=None, epsilon=None,
                 decay: float = 0.55, target: float = 0.45):
        super().__init__(params)
        self.kwargs = dict(A=A, D=D, epsilon=epsilon, decay=decay,
                           target=target)

    def kernel_init(self, gen, x0, logf):
        return bia_init(x0, **self.kwargs)

    def kernel_step(self, gen, x, tune, logf, adapt):
        return bia_step(gen, x, tune, logf)


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


def _index_mask(gen, x, tune: IndexSelect):
    """``(C, n)`` mask of the coordinates each chain updates: k drawn
    without replacement (reference randind), or one group."""
    if tune.groups_mask is None:
        order = torch.argsort(_rand(gen, x.shape, x), -1)[:, :tune.k]
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter(
            1, order, True)
    G = tune.groups_mask.shape[0]
    g = torch.clamp((_rand(gen, x.shape[:1], x) * G).long(), max=G - 1)
    return tune.groups_mask[g]


def bmc3_init(x0, k=1) -> BMC3Tune:
    return _index_init(x0, k)


def bmc3_step(gen, x, tune: BMC3Tune, logf):
    """Flip the selected coordinates, MH accept (reference bmc3.jl:57-68)."""
    y = torch.where(_index_mask(gen, x, tune), 1.0 - x, x)
    lfy, lfx = _pair(logf, y, x)
    accept = torch.log(_rand(gen, x.shape[:1], x)) < lfy - lfx
    return torch.where(accept[:, None], y, x), tune


class BMC3(SamplerSpec):
    transform = False

    def __init__(self, params, k=1):
        super().__init__(params)
        self.k = k

    def kernel_init(self, gen, x0, logf):
        return bmc3_init(x0, self.k)

    def kernel_step(self, gen, x, tune, logf, adapt):
        return bmc3_step(gen, x, tune, logf)


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


def bmg_step(gen, x, tune: BMGTune, logf):
    """Metropolised Gibbs with conditional Bernoulli proposals (reference
    bmg.jl:57-104)."""
    mask = _index_mask(gen, x, tune)
    probs_x = _cond_probs(logf, x)
    theta = (_rand(gen, x.shape, x) < probs_x).to(x.dtype)
    y = torch.where(mask, theta, x)
    if x.shape[1] == 1:
        return y, tune

    def masked_logq(probs, z):
        lq = torch.where(z == 1.0, torch.log(probs), torch.log1p(-probs))
        return torch.sum(torch.where(mask, lq, 0.0), -1)

    qy = masked_logq(probs_x, y)
    qx = masked_logq(_cond_probs(logf, y), x)
    lfy, lfx = _pair(logf, y, x)
    accept = torch.log(_rand(gen, x.shape[:1], x)) < (lfy - qy) - (lfx - qx)
    return torch.where(accept[:, None], y, x), tune


class BMG(SamplerSpec):
    transform = False

    def __init__(self, params, k=1):
        super().__init__(params)
        self.k = k

    def kernel_init(self, gen, x0, logf):
        return bmg_init(x0, self.k)

    def kernel_step(self, gen, x, tune, logf, adapt):
        return bmg_step(gen, x, tune, logf)
