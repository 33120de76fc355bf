"""Likelihood-tempered sequential Monte Carlo with systematic resampling.

Counterpart of the JAX package's ``infer/smc.py`` (an inference backend the
reference lacks).  Anatomy, as there:

- particles live in the model's link-transformed space; the prior and the
  tempered likelihood come from the compiled block densities (the
  ``prior_only`` variant and the difference of the full density from it),
  evaluated for all particles by one ``torch.func.vmap`` each,
- adaptive temperature ladder: each stage solves for the Δβ whose
  effective sample size equals ``ess_target``, by bisection,
- systematic resampling (one uniform, stratified positions),
- MCMC rejuvenation: random-walk Metropolis steps per temperature, scaled
  by the resampled particles' spread.

The JAX package runs the stages and the bisection as two nested
``lax.while_loop``s.  Here the stages are a host loop with one device sync
each: the particles' N log-likelihoods are fetched once per stage, and the
bisection runs on the host over them in float64 (50 halvings at most, as
there).  Rejuvenation is a device loop with no sync.

Systematic resampling clamps each index to N - 1: ``cumsum`` of the weights
may round below the last stratified point, where ``searchsorted`` returns N
(JAX clamps the gather that follows silently; here the clamp is explicit).

With ``mesh``, the particles are sharded over its particle axis: each rank
draws, scores and rejuvenates its own block with a generator seeded from
``(seed, rank)``.  The log-likelihoods and the particles are gathered once
per stage, so the temperature, the evidence, the resampling (its uniform
taken from the axis's rank 0) and the proposal scale are the same on every
rank, and each rank keeps its block of the resampled particles.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..model.compile import compile_model
from ..model.model import Model
from ..ops import random as R
from ..parallel.mesh import MeshComm


@dataclasses.dataclass
class SMCResult:
    particles: dict[str, np.ndarray]   # constrained draws {site: (N, ...)}
    log_evidence: float                # log marginal-likelihood estimate
    n_stages: int
    ess_final: float
    params: tuple[str, ...]


def systematic_resample(key, logw: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling indices (one uniform per generation, from the
    key ``key``, which every rank holds alike), each in [0, n - 1]."""
    w = torch.softmax(logw, dim=0)
    cum = torch.cumsum(w, dim=0)
    u0 = R.uniform(key, (), w.dtype)
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.searchsorted(cum, pts).clamp_(max=n - 1)


def _ess_frac(logw: np.ndarray) -> float:
    w = np.exp(logw - logw.max())
    w /= w.sum()
    return 1.0 / (len(w) * np.sum(w ** 2))


def _next_beta(beta: float, ll: np.ndarray, ess_target: float) -> float:
    """Largest Δβ with ESS(Δβ·ll) >= ess_target (bisection)."""
    full = min(1.0 - beta, 1.0)
    if _ess_frac(full * ll) >= ess_target:
        return min(beta + full, 1.0)
    lo, hi = 0.0, full
    for _ in range(50):
        if not hi - lo > 1e-6:
            break
        mid = 0.5 * (lo + hi)
        if _ess_frac(mid * ll) >= ess_target:
            lo = mid
        else:
            hi = mid
    return min(beta + lo, 1.0)


def smc(model: Model, inputs: dict, inits: dict, params=None, *,
        n_particles: int = 1024, ess_target: float = 0.5,
        rejuvenation_steps: int = 10, max_stages: int = 100, seed: int = 0,
        device=None, dtype=None, mesh=None,
        particle_axis: str = "chains") -> SMCResult:
    """Sample the posterior by tempering prior -> posterior on ``device``
    (required, as for ``mcmc``), with random draws keyed as the JAX
    package keys them: from ``key(seed)``, particle ``i`` drawn from the
    prior with ``fold_in(kz, i)``, and each stage's resampling and each
    RWM step from keys split off the run's key, every particle's normals
    and uniforms at its own counters of the whole draw.

    ``rejuvenation_steps`` is the main quality knob: hierarchical posteriors
    with heavy-tailed priors (line/rats-style variance terms) need ~20-50
    RWM refresh steps per temperature for unbiased moments.

    ``mesh`` (a ``DeviceMesh``) shards the particles over its
    ``particle_axis``, which must divide ``n_particles``; every rank
    returns all particles; each rank draws its particles' counters of the
    whole draws, so the run draws the unsharded run's numbers."""
    if device is None:
        raise ValueError("smc needs an explicit device (e.g. 'cuda' or 'cpu')")
    comm = MeshComm(mesh, particle_axis)
    N = n_particles
    local = comm.local_chains(N)
    first = comm.chain_rank * local
    cm = compile_model(model, inputs, inits, device=device, dtype=dtype)
    if params is None:
        observed = set(model.keys("observed")) if model.samplers else set()
        params = [n for n in cm.stochastic if n not in observed]
    params = tuple([params] if isinstance(params, str) else params)

    pack, unpack, _, log_post = cm.block_functions(params, transform=True)
    _, _, _, log_prior = cm.block_functions(params, transform=True,
                                            prior_only=True)
    state0 = {n: cm.tensor(np.broadcast_to(np.asarray(inits[n], dtype=np.float64),
                                           cm.sites[n].shape))
              for n in cm.stochastic}
    key = R.key(seed, cm.device)
    key, kz = R.split(key)
    rows = torch.arange(first, first + local, device=cm.device)

    lprior = torch.func.vmap(lambda z: log_prior(z, state0))
    lpost = torch.func.vmap(lambda z: log_post(z, state0))

    def target(z, beta):
        """(prior + beta * likelihood, likelihood) of every particle.  In the
        likelihood that the next temperature is solved from, a value that is
        not finite (heavy-tailed priors draw particles where it underflows)
        counts as -1e30, so 0 * ll stays defined."""
        lp0 = lprior(z)
        ll = lpost(z) - lp0
        return (lp0 + beta * ll,
                torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -1e30)))

    with torch.no_grad():
        # init particles from the prior via forward sampling, packed
        stacked = {k: v.expand(local, *v.shape) for k, v in state0.items()}
        drawn = cm.forward_sample(R.fold_in(kz.expand(local, 2), rows),
                                  stacked, names=params)
        z = torch.func.vmap(pack)(drawn)
        # clip unconstrained coordinates: extreme prior tails can overflow
        # to +-inf (log of an underflowed Gamma draw)
        z = torch.clamp(torch.nan_to_num(z, nan=0.0, posinf=1e8, neginf=-1e8),
                        -1e8, 1e8)
        d = z.shape[1]
        cells = (rows[:, None] * d + torch.arange(d, device=cm.device)).reshape(-1)
        beta, stage = 0.0, 0
        logZ = torch.zeros((), dtype=cm.dtype, device=cm.device)
        _, ll = target(z, 0.0)
        while beta < 1.0 and stage < max_stages:
            ll = comm.gather_chains(ll)             # every particle's
            beta2 = _next_beta(beta, ll.double().cpu().numpy(), ess_target)
            logw = (beta2 - beta) * ll
            logZ = logZ + torch.logsumexp(logw, dim=0) - math.log(N)
            key, kr, kj = R.split(key, 3)
            idx = systematic_resample(kr, logw, N)
            z = comm.gather_chains(z)[idx]
            # proposal scale from resampled particle spread
            scale = 2.38 / math.sqrt(d) * torch.std(z, dim=0, correction=0) + 1e-6
            z = z[first:first + local]              # this rank's block
            lp, ll = target(z, beta2)
            for _ in range(rejuvenation_steps):
                kj, kp, ka = R.split(kj, 3)
                prop = z + scale * R.normal(kp, (N * d,), z.dtype,
                                            index=cells).reshape(local, d)
                lp1, ll1 = target(prop, beta2)
                u = R.uniform(ka, (N,), z.dtype, index=rows)
                acc = torch.log(u) < lp1 - lp
                z = torch.where(acc[:, None], prop, z)
                lp = torch.where(acc, lp1, lp)
                ll = torch.where(acc, ll1, ll)
            beta, stage = beta2, stage + 1
        values = torch.func.vmap(lambda v: unpack(v, state0))(
            comm.gather_chains(z))
    return SMCResult(
        particles={k: v.cpu().numpy() for k, v in values.items()},
        log_evidence=float(logZ), n_stages=stage,
        # weights are uniform after the last resampling
        ess_final=1.0, params=params)
