"""ChEES-HMC: cross-chain adaptive trajectory-length HMC (Hoffman, Radul &
Sountsov 2021, "An Adaptive MCMC Scheme for Setting Trajectory Lengths in
Hamiltonian Monte Carlo"), batched over chains.

The reference has no counterpart; the JAX package added it because NUTS
run over a batch of chains in lockstep costs the deepest tree of every
iteration.  ChEES-HMC runs plain HMC whose step size and trajectory length
are shared by every chain and adapted from cross-chain statistics (the
Change-in-Estimator-of-Expected-Square criterion), so:

- every chain does the same ``L`` leapfrog steps each iteration, with no
  masking: ``L = clip(ceil(h * T / eps), 1, max_steps)`` is one host
  integer per iteration, read with one sync;
- the trajectory jitter ``h`` is a base-2 Halton value of the iteration
  counter ``it``, shared across chains and advancing after warmup too;
- the cross-chain means the JAX package takes with ``lax.pmean`` over its
  chain axis are means over dim 0 here, and over every rank's chains under
  a mesh (``MeshComm.chain_mean``, weighted by each rank's chain count), so
  every rank holds the same step size, trajectory and mass.

Adapted quantities are shared by construction and stored once: the step
sizes, the dual-averaging and Adam state and the trajectory length as 0-d
tensors, the inverse mass and the window statistics as ``(dim,)`` tensors,
the counters as host integers.

Warmup adapts the step size by Nesterov dual averaging on the cross-chain
mean accept probability and the trajectory length by Adam ascent on the
ChEES gradient estimate  E_accept[ (|x'-x̄|^2 - |x-x̄|^2) (x'-x̄)·p' ].

Random draws per step, from the block's per-chain keys (``ops/random.py``):
the momentum noise ``(C, dim)`` from ``fold_in(key, 0)`` and one
acceptance uniform per chain from ``fold_in(key, 1)``, which are the JAX
package's ``kp, ka = split(key)``: a chain draws its numbers.

On a mesh's data axis a block may hold some sites as the rank's slice
(``coords``, a ``parallel.mesh.BlockCoords``): the momentum noise is drawn
at the unsharded flat length and cut, the energy change's and the ChEES
criterion's sums over coordinates are completed over the data group, and
the mass adaptation stays per coordinate, on the rank's own.

The stand-alone ``chees_step`` runs the ``L`` leapfrogs as a plain loop
(``_trajectory``); the engine replays one captured leapfrog ``L`` times
(``GraphedTrajectory``), with the step size a tensor on the device, as the
JAX engine runs the trajectory as a ``lax.while_loop``.  Momentum, the MH
test and the adaptation, with its collectives, stay outside the graph.  On
a data rank the captured leapfrog is cut once, at its split density's
all-reduce (``utils.graphs.cut``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..ops import random as R
from ..parallel.mesh import WHOLE, BlockCoords, MeshComm
from ..utils.graphs import Captured
from .base import SamplerSpec
from .nuts import nutsepsilon

#: the collectives of a run without a mesh: means over dim 0
_ONE_RANK = MeshComm()


class ChEESTune(NamedTuple):
    epsilon: torch.Tensor     # current step size (0-d)
    epsilonbar: torch.Tensor  # dual-averaged step size, used after warmup
    Hbar: torch.Tensor
    mu: torch.Tensor
    m: int                    # adaptation iterations so far
    traj: torch.Tensor        # trajectory length T (time units)
    adam_m: torch.Tensor      # Adam first moment of d log T
    adam_v: torch.Tensor      # Adam second moment
    target: torch.Tensor      # step-size accept target
    max_steps: int            # cap on leapfrog steps per iteration
    minv: torch.Tensor        # (dim,) diagonal inverse mass
    # windowed cross-chain mass adaptation (warmup only; window == 0
    # disables).  The pooled variance over chains x iterations is
    # E_t[Var_c(x)] + Var_t[E_c(x)]: w_sw sums the within-iteration
    # cross-chain variances, a Welford recursion over iterations tracks the
    # spread of the cross-chain means (w_mean, w_m2).
    w_n: int                  # iterations in the current window
    w_mean: torch.Tensor      # (dim,)
    w_m2: torch.Tensor        # (dim,)
    w_sw: torch.Tensor        # (dim,)
    window: int               # refresh period (0 = off)
    it: int                   # iterations so far, warmup or not: drives the
                              # Halton jitter, which must go on after warmup
                              # (a frozen jitter is fixed-length HMC, whose
                              # periodic trajectories resonate on
                              # near-Gaussian posteriors)


#: the fields held per coordinate of the block's flat vector (a data rank's
#: coordinates where the block holds slices: a sharded run's file joins them
#: into the unsharded order, ``output.fileio``)
ChEESTune.COORD_LEAVES = ("minv", "w_mean", "w_m2", "w_sw")


def _halton2(m: int) -> float:
    """Base-2 Halton (van der Corput) value of the integer ``m``: its low 16
    bits reversed into [0, 1).  Exact in float32 and float64."""
    return sum(0.5 ** (k + 1) for k in range(16) if (m >> k) & 1)


def chees_init(key, x0, logfgrad, epsilon: float | None = None,
               traj: float | None = None, target: float = 0.75,
               max_steps: int = 1024, minv0=None,
               mass_window: int = 0, comm: MeshComm | None = None,
               coords: BlockCoords = WHOLE) -> ChEESTune:
    """Tune for chains ``x0 (C, dim)``.  ``epsilon`` defaults to the
    geometric mean of the per-chain NUTS doubling searches, ``traj`` to one
    step.  ``minv0`` seeds the diagonal inverse mass; ``mass_window > 0``
    refreshes it every that many warmup iterations from pooled cross-chain
    statistics (the recommended mode above ~1k dimensions).  ``comm`` pools
    the chains of every rank of a mesh; ``coords`` are the block's
    coordinates on a data rank (module docstring), to which a ``minv0``
    per coordinate of the unsharded flat vector is cut."""
    f = dict(dtype=x0.dtype, device=x0.device)
    comm = comm or _ONE_RANK
    if epsilon is None:
        # per-chain doubling searches agree only in order of magnitude;
        # every chain starts (and stays) on their geometric mean
        eps = torch.exp(comm.chain_mean(torch.log(
            nutsepsilon(key, x0, logfgrad, coords))))
    else:
        eps = torch.as_tensor(float(epsilon), **f)
    dim = x0.shape[1:]
    zero = torch.zeros((), **f)
    return ChEESTune(
        epsilon=eps, epsilonbar=eps.clone(), Hbar=zero,
        mu=torch.log(10.0 * eps), m=0,
        traj=eps.clone() if traj is None else torch.as_tensor(float(traj), **f),
        adam_m=zero, adam_v=zero, target=torch.as_tensor(float(target), **f),
        max_steps=int(max_steps),
        minv=(torch.ones(dim, **f) if minv0 is None
              else coords.cut(torch.as_tensor(minv0, **f)).expand(dim).clone()),
        w_n=0, w_mean=torch.zeros(dim, **f), w_m2=torch.zeros(dim, **f),
        w_sw=torch.zeros(dim, **f), window=int(mass_window), it=0)


def _steps(h: float, traj, eps, max_steps: int) -> int:
    """L = clip(ceil(h * T / eps), 1, max_steps), computed in the tensors'
    dtype: the one host sync of an iteration (an underflowed step, T/0 =
    inf, gives ``max_steps``)."""
    v = float(torch.ceil(h * traj / eps))
    return int(min(max(v, 1.0), float(max_steps)))


def _trajectory(x, p, logf, grad, eps, minv, L: int, logfgrad):
    """``L`` leapfrog steps of every chain from ``(x, p)`` with the 0-d step
    ``eps`` and the diagonal inverse mass ``minv``: the plain loop.
    Returns the end's position, momentum, log-density and gradient."""
    for _ in range(L):
        p = p + 0.5 * eps * grad
        x = x + eps * (minv * p)
        logf, grad = logfgrad(x)
        p = p + 0.5 * eps * grad
    return x, p, logf, grad


def _leapfrog_step(b, logfgrad):
    """One step of ``_trajectory``'s loop on the tensors ``b``, updated in
    place (``eps`` a 0-d tensor on the device)."""
    eps, minv = b["eps"], b["minv"]
    p = b["p"] + 0.5 * eps * b["grad"]
    x = b["x"] + eps * (minv * p)
    logf, grad = logfgrad(x)
    b["p"].copy_(p + 0.5 * eps * grad)
    b["x"].copy_(x)
    b["logf"].copy_(logf)
    b["grad"].copy_(grad)


def _leapfrog_on(density, b, state):
    """``_leapfrog_step`` with the density ``density(x, state) -> (logf,
    grad)`` on the model state ``state``."""
    _leapfrog_step(b, lambda x: density(x, state))


class GraphedTrajectory:
    """``_trajectory`` for the engine: one leapfrog step captured once per
    run (``utils.graphs.Captured``) and replayed ``L`` times.  The density
    ``density(x, state) -> (logf, grad)`` reads the model state loaded by
    ``load_state`` once per block step.  Takes the arguments of
    ``_trajectory`` (its ``logfgrad`` is not used) and returns the same
    values."""

    def __init__(self, density):
        # the body holds the density, not this object: no reference cycle,
        # so the graph goes when the kernel does
        self.cap = Captured(functools.partial(_leapfrog_on, density))

    def load_state(self, state):
        self.cap.load_state(state)

    def __call__(self, x, p, logf, grad, eps, minv, L: int, logfgrad):
        cap = self.cap
        cap.load(x=x, p=p, logf=logf, grad=grad, eps=eps, minv=minv)
        cap.run(L)
        return tuple(cap.bufs[k].clone() for k in ("x", "p", "logf", "grad"))


def chees_step(key, x, tune: ChEESTune, logfgrad, adapt: bool,
               comm: MeshComm | None = None, trajectory=None,
               coords: BlockCoords = WHOLE):
    """One ChEES-HMC iteration for chains ``x (C, dim)``: jittered
    fixed-length leapfrog + MH, then (when ``adapt``) the cross-chain
    dual-averaging, Adam and mass-window updates, pooled over every rank's
    chains by ``comm``.  ``trajectory`` runs the ``L`` leapfrogs
    (``_trajectory``'s contract; by default that plain loop); ``coords``
    are the block's coordinates on a data rank.  Returns the new positions
    and tune."""
    dt = x.dtype
    C = x.shape[0]
    comm = comm or _ONE_RANK
    eps = tune.epsilon if adapt else tune.epsilonbar
    h = _halton2(tune.it)
    L = _steps(h, tune.traj, eps, tune.max_steps)

    # diagonal mass: p ~ N(0, M) with M = minv^-1, kinetic p' minv p / 2,
    # dx/dt = minv * p (Neal 2011 eq. 5.29-5.31)
    minv = tune.minv
    p0 = coords.randn(key, x, fold=0) * torch.rsqrt(minv)
    logf0, grad0 = logfgrad(x)
    x1, p1, logf1, grad1 = (trajectory or _trajectory)(
        x, p0, logf0, grad0, eps, minv, L, logfgrad)

    k1, k0 = coords.sums(p1 * (minv * p1), p0 * (minv * p0))
    dH = (logf1 - 0.5 * k1) - (logf0 - 0.5 * k0)
    dH = torch.where(torch.isnan(dH), -torch.inf, dH)
    alpha = torch.clamp(torch.exp(dH), max=1.0)
    u = R.uniform(key, (), dt, fold=1)
    x2 = torch.where((u < alpha)[:, None], x1, x)
    if not adapt:
        return x2, tune._replace(it=tune.it + 1)

    # ---- cross-chain adaptation ----------------------------------------
    abar = comm.chain_mean(alpha)
    # dual averaging (Hoffman-Gelman) on the cross-chain accept rate
    mh = float(tune.m + 1)
    Hbar = (1.0 - 1.0 / (mh + 10.0)) * tune.Hbar + (tune.target - abar) / (mh + 10.0)
    log_eps = tune.mu - math.sqrt(mh) / 0.05 * Hbar
    w = mh ** -0.75
    log_epsbar = w * log_eps + (1.0 - w) * torch.log(tune.epsilonbar)

    # ChEES gradient for the trajectory length (accept-weighted mean)
    xbar = comm.chain_mean(x)
    d_prop = x1 - xbar
    d_cur = x - xbar
    sq_prop, sq_cur, along = coords.sums(d_prop * d_prop, d_cur * d_cur,
                                         d_prop * (minv * p1))
    dsq = sq_prop - sq_cur
    g_chain = dsq * along * h
    # a divergent trajectory has zero accept probability, but 0 * nan would
    # still poison the mean
    g_chain = torch.where(torch.isfinite(g_chain), g_chain, 0.0)
    g = comm.chain_mean(alpha * g_chain) / torch.clamp(abar, min=1e-6)
    g = g / torch.clamp(torch.abs(g), min=1e-12)   # dimensionless Adam step

    b1, b2, lr = 0.9, 0.95, 0.025
    adam_m = b1 * tune.adam_m + (1.0 - b1) * g
    adam_v = b2 * tune.adam_v + (1.0 - b2) * g * g
    mhat = adam_m / (1.0 - b1 ** mh)
    vhat = adam_v / (1.0 - b2 ** mh)
    log_traj = torch.log(tune.traj) + lr * mhat / (torch.sqrt(vhat) + 1e-8)
    new_traj = torch.clamp(torch.exp(log_traj), tune.epsilon,
                           tune.epsilonbar * tune.max_steps)
    new_traj = torch.where(torch.isfinite(new_traj), new_traj, tune.traj)

    # ---- windowed cross-chain mass adaptation ---------------------------
    # pooled variance over chains x window iterations:
    #   Var = E_t[Var_c(x)] + Var_t[E_c(x)]
    mu = tune.mu
    minv_new, w_n, w_mean, w_m2, w_sw = (tune.minv, tune.w_n, tune.w_mean,
                                         tune.w_m2, tune.w_sw)
    if tune.window > 0:
        mc = comm.chain_mean(x2)
        vc = comm.chain_mean((x2 - mc) ** 2)
        w_n += 1
        delta = mc - w_mean
        w_mean = w_mean + delta / w_n
        w_m2 = w_m2 + delta * (mc - w_mean)
        w_sw = w_sw + vc
        if w_n >= tune.window:
            nf = float(w_n)
            var = w_sw / nf + w_m2 / max(nf - 1.0, 1.0)
            # Stan-style shrinkage toward 1e-3, weighted by the effective
            # count (iterations x chains: cross-chain pooling is why a short
            # window suffices)
            ne = nf * C * comm.chain_size
            minv_new = (ne / (ne + 5.0)) * var + 1e-3 * (5.0 / (ne + 5.0))
            w_n = 0
            w_mean, w_m2, w_sw = (torch.zeros_like(w_mean),
                                  torch.zeros_like(w_m2), torch.zeros_like(w_sw))
            # a metric change invalidates the step-size statistics:
            # re-center dual averaging on the current step
            Hbar = torch.zeros_like(Hbar)
            mu = math.log(10.0) + log_eps

    return x2, ChEESTune(
        epsilon=torch.exp(log_eps), epsilonbar=torch.exp(log_epsbar),
        Hbar=Hbar, mu=mu, m=tune.m + 1, traj=new_traj, adam_m=adam_m,
        adam_v=adam_v, target=tune.target, max_steps=tune.max_steps,
        minv=minv_new, w_n=w_n, w_mean=w_mean, w_m2=w_m2, w_sw=w_sw,
        window=tune.window, it=tune.it + 1)


class ChEESHMC(SamplerSpec):
    """Engine block: ChEES-HMC over a parameter block (transformed space).

    ``ChEESHMC("beta")`` or ``ChEESHMC(["beta", "s2"], target=0.8)``: a
    drop-in for a NUTS block when running many chains, where every chain
    does the same work per iteration.  ``mass_window > 0`` learns a diagonal
    inverse mass during warmup from pooled cross-chain statistics;
    ``minv0`` seeds it (held fixed with ``mass_window=0``).

    Initialization contract: shared adaptation assumes every chain starts
    near the posterior's typical set.  Chains started far away see ~zero
    accept probability at the pooled step size, freeze, and poison the
    pooled statistics, and unlike per-chain NUTS they cannot recover one by
    one.  Start from ADVI draws (``infer.advi`` and ``ADVIResult.sample``)
    or from one init that every chain shares."""

    transform = True
    needs_grad = True
    holds_slices = True

    def __init__(self, params, epsilon=None, traj=None, target=0.75,
                 max_steps=1024, minv0=None, mass_window: int = 0):
        super().__init__(params)
        self.epsilon = epsilon
        self.traj = traj
        self.target = target
        self.max_steps = max_steps
        self.minv0 = minv0
        self.mass_window = int(mass_window)

    def build(self, cm):
        # the cross-chain statistics pool every rank's chains
        return self.bind(
            cm, lambda key, x0, f, **kw: self.kernel_init(key, x0, f, cm.comm,
                                                          **kw),
            lambda key, x, tune, f, adapt, graphed=None, **kw: self.kernel_step(
                key, x, tune, f, adapt, cm.comm, graphed, **kw),
            graphed=lambda density, coords=WHOLE: GraphedTrajectory(density))

    def kernel_init(self, key, x0, logfgrad, comm=None, coords=WHOLE):
        return chees_init(key, x0, logfgrad, self.epsilon, self.traj,
                          self.target, self.max_steps, minv0=self.minv0,
                          mass_window=self.mass_window, comm=comm,
                          coords=coords)

    def kernel_step(self, key, x, tune, logfgrad, adapt, comm=None,
                    graphed=None, coords=WHOLE):
        return chees_step(key, x, tune, logfgrad, adapt, comm=comm,
                          trajectory=graphed, coords=coords)
