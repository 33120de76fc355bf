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

The slice-variable formulation, uniform proposal selection within the
candidate set, divergence cutoff (+1000), U-turn criterion (nuts.jl:183-187)
and dual-averaging schedule (nuts.jl:63-92) match the reference; the tree
depth is capped at ``max_depth`` (default 10, as in Stan).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def _kinetic(r, minv):
    return 0.5 * torch.sum(r * r if minv is None else r * (minv * r), dim=-1)


def nutsepsilon(gen, x, logfgrad):
    """Initial step size per chain by doubling/halving search (reference
    nuts.jl:192-205)."""
    r0 = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return _epsilon_search(x, r0, logfgrad)


def _epsilon_search(x, r0, logfgrad):
    logf0, grad0 = logfgrad(x)
    k0 = torch.sum(r0 * r0, dim=-1)

    def probe(eps):
        _, rp, logfp, _ = _leapfrog(x, r0, grad0, eps, logfgrad)
        prob = torch.exp(logfp - logf0 - 0.5 * (torch.sum(rp * rp, dim=-1) - k0))
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


def nuts_init(gen, x0, logfgrad, epsilon=None, target: float = 0.6,
              mass_window: int = 0, minv0=None) -> NUTSTune:
    """Tune init for chains ``x0 (C, dim)`` (reference NUTSTune ctor,
    nuts.jl:22-27; epsilon search when not given, nuts.jl:29-30).
    ``minv0`` seeds the diagonal inverse mass with a posterior-variance
    estimate; with ``mass_window == 0`` it is used as-is, never
    refreshed."""
    C = x0.shape[0]
    f = dict(dtype=x0.dtype, device=x0.device)
    i32 = dict(dtype=torch.int32, device=x0.device)
    eps = (nutsepsilon(gen, x0, logfgrad) if epsilon is None
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
              else torch.as_tensor(minv0, **f).expand(x0.shape).clone()),
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


def _subtree_turned(x_ck, r_ck, x, r, pm, idx_min, idx_max, minv):
    """Per chain: U-turn between the current (odd) leaf and every buffered
    subtree start it closes, slots ``idx_min..idx_max`` of the ``(C,
    max_depth, dim)`` buffers.  Criterion oriented by build direction
    ``pm``: dx = pm * (x_new - x_start); turned iff dx.v_start < 0 or
    dx.v_new < 0 with v the velocity minv*r (reference nouturn,
    nuts.jl:183-187)."""
    sl = slice(idx_min, idx_max + 1)
    dx = pm[:, None, None] * (x[:, None, :] - x_ck[:, sl])
    v_ck = r_ck[:, sl] if minv is None else minv[:, None, :] * r_ck[:, sl]
    v = r if minv is None else minv * r
    turned = ((torch.sum(dx * v_ck, dim=-1) < 0)
              | (torch.sum(dx * v[:, None, :], dim=-1) < 0))
    return turned.any(dim=-1)


def _build_subtree(gen, x0, r0, grad0, pm, j, eps, logfgrad, logp0, logu0,
                   x_ck, r_ck, minv, active):
    """Build ``2**j`` leapfrog steps in direction ``pm (C,)`` from end states
    (x0, r0, grad0), for the chains in ``active``.  Returns the new end
    states, each subtree's uniform proposal, candidate count n', validity
    s' and accept stats — the contract of the reference's recursive
    buildtree (nuts.jl:139-180).  A chain stops at the leaf that diverges
    or turns; later leaves leave it as it was."""
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
        logp = logf - _kinetic(rn, minv)
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
        u = torch.rand(act.shape, generator=gen, dtype=dt, device=x.device)
        take = valid & (u * nprime.to(dt) < 1.0)
        xprop = torch.where(_col(take), xn, xprop)

        idx_min, idx_max = _ckpt_idxs(leaf)
        if leaf % 2 == 0:
            x_ck[:, idx_max] = torch.where(a2, xn, x_ck[:, idx_max])
            r_ck[:, idx_max] = torch.where(a2, rn, r_ck[:, idx_max])
            turned = torch.zeros_like(act)
        else:
            turned = _subtree_turned(x_ck, r_ck, xn, rn, pm, idx_min,
                                     idx_max, minv)
        sprime = sprime & ~diverged & ~turned
    return x, r, grad, xprop, nprime, sprime, alpha, nalpha


def nuts_sub(gen, x, epsilon, logfgrad, max_depth=10, minv=None):
    """One NUTS transition per chain at fixed step sizes ``epsilon (C,)``
    (reference nuts_sub!, nuts.jl:95-126).  With ``minv``, momenta are drawn
    from N(0, M) and the dynamics use the diagonal metric.  Returns the new
    positions and each chain's accept stats and tree depth."""
    C, dim = x.shape
    f = dict(dtype=x.dtype, device=x.device)
    if minv is None:
        minv = torch.ones_like(x)
    r0 = torch.randn(C, dim, generator=gen, **f) / torch.sqrt(minv)
    logf0, grad0 = logfgrad(x)
    logp0 = logf0 - _kinetic(r0, minv)
    logu0 = logp0 + torch.log(torch.rand(C, generator=gen, **f))

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
        pm = torch.where(torch.rand(C, generator=gen, **f) > 0.5, 1.0, -1.0).to(x.dtype)
        u_acc = torch.rand(C, generator=gen, **f)
        left = _col(pm < 0)
        (x_new, r_new, g_new, xprop, nprime, sprime, alpha2, nalpha2
         ) = _build_subtree(gen, torch.where(left, xm, xp),
                            torch.where(left, rm, rp),
                            torch.where(left, gm, gp), pm, j, epsilon,
                            logfgrad, logp0, logu0, x_ck, r_ck, minv, s)
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
        no_turn = ((torch.sum(xdiff * (minv * rm), dim=-1) >= 0)
                   & (torch.sum(xdiff * (minv * rp), dim=-1) >= 0))
        alpha = torch.where(s, alpha2, alpha)
        nalpha = torch.where(s, nalpha2, nalpha)
        depth = depth + s.to(torch.int32)
        s = s & sprime & no_turn
    return xcur, alpha, nalpha, depth


def nuts_step(gen, x, tune: NUTSTune, logfgrad, adapt: bool, max_depth=10):
    """NUTS transition + dual-averaging update for every chain (reference
    sample!, nuts.jl:63-92).  ``adapt`` is the warmup flag."""
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
    x2, alpha, nalpha, depth = nuts_sub(gen, x, eps_used, logfgrad,
                                        max_depth, minv=minv)
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

    def __init__(self, params, epsilon=None, target: float = 0.6,
                 max_depth: int = 10, mass_window: int = 0, minv0=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.target = float(target)
        self.max_depth = int(max_depth)
        self.mass_window = int(mass_window)
        self.minv0 = minv0

    def kernel_init(self, gen, x0, logfgrad):
        return nuts_init(gen, x0, logfgrad, epsilon=self.epsilon,
                         target=self.target, mass_window=self.mass_window,
                         minv0=self.minv0)

    def kernel_step(self, gen, x, tune, logfgrad, adapt):
        return nuts_step(gen, x, tune, logfgrad, adapt, self.max_depth)
