"""Approximate Bayesian computation MH sampler, batched over chains
(reference src/samplers/abc.jl).

Summary-statistic matching with kernel-weighted tolerances, ``nsim``
replicate simulations, tolerance decay, optional randomized tolerances and
a ``maxdraw`` retry loop.  The reference walks the graph again to simulate
the data nodes for each draw (abc.jl:55-68); here the simulations are the
compiled model's ``forward_sample``, all ``nsim`` of every chain in one call
(the state repeated ``nsim`` times along the chain axis).  The retry loop
runs in lockstep: a draw proposes for every chain, and a chain takes the
first draw it accepts (the reference's ``break``) and keeps it.  A chain's
draws are all proposed from its current value and share nothing else, so
``DRAWS_PER_CALL`` of them are scored at once for every chain (one
simulation call for all of them) and the first accepted one is kept: the
same draws as one at a time, at a fraction of the calls.  The host syncs
once per batch of draws, to stop when every chain has accepted.

Proposals are made in the block's link-transformed space, like the
reference (unlist/relist with transform=true, abc.jl:45, 103-110).

Random draws, in order: at init, the nsim simulations and, with
``randeps``, the tolerances ``(C, nsim)`` (exponential); per batch of M
draws in a step, the proposals ``(C, M, dim)``, the simulations, the
tolerances ``(C, M, nsim)`` with ``randeps``, and the acceptance uniforms
``(C, M)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .base import BlockKernel, SamplerSpec, summed

#: draws of the ``maxdraw`` loop scored together, per chain
DRAWS_PER_CALL = 25


class ABCTune(NamedTuple):
    Tsim: torch.Tensor          # (C, nsim, Tdim) summaries at the current values
    epsilon: torch.Tensor       # (C, nsim) tolerances
    epsilonprime: torch.Tensor  # (C, nsim) randomized tolerances


def _default_dist(Tsim, Tobs):
    return torch.sqrt(torch.sum((Tsim - Tobs) ** 2))


def _kernel_logpdf(kind: str, eps, d):
    """log kernel(0, eps).pdf(d) for the tolerance kernels the reference
    admits (SymDistributionType, extensions.jl:51-55)."""
    if kind == "uniform":      # SymUniform(0, eps) ~ Uniform(-eps, eps)
        return torch.where(torch.abs(d) <= eps, -torch.log(2.0 * eps), -torch.inf)
    if kind == "normal":
        return -0.5 * (d / eps) ** 2 - torch.log(eps) - 0.5 * math.log(2 * math.pi)
    if kind == "epanechnikov":
        u = d / eps
        return torch.where(torch.abs(u) <= 1, torch.log(0.75 * (1 - u ** 2) / eps),
                           -torch.inf)
    raise ValueError(f"unsupported kernel {kind!r}")


class ABC(SamplerSpec):
    """ABC(params, scale, summary, epsilon; kernel='uniform',
    dist=euclidean, proposal='normal', maxdraw=1, nsim=1, decay=1.0,
    randeps=False): the reference ABC ctor (abc.jl:23-147).

    ``summary`` maps one chain's value of a data node to its summary
    statistics, and ``dist`` two summary vectors to a distance; both are
    batched over chains and simulations with ``torch.func.vmap``, so they
    must be written in operations that batch (e.g. a quantile by
    ``torch.sort``: ``torch.quantile`` has no batching rule)."""

    transform = True

    def __init__(self, params, scale, summary: Callable, epsilon: float,
                 kernel: str = "uniform", dist: Callable = _default_dist,
                 proposal: str = "normal", maxdraw: int = 1, nsim: int = 1,
                 decay: float = 1.0, randeps: bool = False):
        super().__init__(params)
        if not 0 <= decay <= 1:
            raise ValueError("decay is not in [0, 1]")
        if kernel not in ("uniform", "normal", "epanechnikov"):
            raise ValueError(f"unsupported kernel {kernel!r}")
        if proposal not in ("normal", "uniform"):
            raise ValueError(f"unsupported proposal {proposal!r}")
        self.scale = scale
        self.summary = summary
        self.epsilon = float(epsilon)
        self.kernel = kernel
        self.dist = dist
        self.proposal = proposal
        self.maxdraw = int(maxdraw)
        self.nsim = int(nsim)
        self.decay = float(decay)
        self.randeps = bool(randeps)

    def build(self, cm) -> BlockKernel:
        pack, unpack, _, logf_prior = cm.block_functions(
            self.params, True, prior_only=True)
        vpack, vunpack = torch.func.vmap(pack), torch.func.vmap(unpack)
        vprior = summed(torch.func.vmap(logf_prior),
                        cm.block_sum(self.params, prior_only=True))
        # data nodes: the block's stochastic targets, minus the block
        targets = cm.model.keys("target", list(self.params))
        stoch = set(cm.stochastic)
        datakeys = [t for t in targets if t in stoch and t not in self.params]
        if not datakeys:
            raise ValueError("ABC block has no stochastic data targets")
        f = dict(dtype=cm.dtype, device=cm.device)
        scale = torch.as_tensor(self.scale, **f)
        eps_target = torch.tensor(self.epsilon, **f)
        decay, nsim = self.decay, self.nsim

        def one_summary(values):
            parts = [torch.ravel(self.summary(values[k])).to(cm.dtype)
                     for k in datakeys]
            return torch.cat(parts) if len(parts) > 1 else parts[0]

        summarize = torch.func.vmap(one_summary)
        distances = torch.func.vmap(torch.func.vmap(self.dist, in_dims=(0, None)))

        def sim_batch(gen, state):
            """(C, nsim, Tdim) summaries of nsim simulations per chain."""
            C = next(iter(state.values())).shape[0]
            rep = {k: v.repeat_interleave(nsim, 0) for k, v in state.items()}
            sim = cm.forward_sample(gen, rep, names=datakeys)
            T = summarize({k: sim[k] for k in datakeys})
            return T.reshape((C, nsim) + T.shape[1:])

        def pi_epsilon(epsp, eps, d):
            logk = _kernel_logpdf(self.kernel, epsp, d)
            if self.randeps:
                logk = logk - epsp / eps - torch.log(eps)   # Exponential(eps) pdf
            return torch.sum(torch.exp(logk), -1)

        def draw_epsprime(gen, eps):
            if not self.randeps:
                return eps
            u = torch.rand(eps.shape, generator=gen, **f)
            return -eps * torch.log1p(-u)

        def init(gen, state):
            Tobs = summarize({k: state[k] for k in datakeys})
            Tsim = sim_batch(gen, state)
            d = distances(Tsim, Tobs)
            eps = (torch.maximum(eps_target, d) if decay > 0
                   else torch.full(d.shape, self.epsilon, **f))
            return ABCTune(Tsim=Tsim, epsilon=eps,
                           epsilonprime=draw_epsprime(gen, eps))

        def noise(gen, shape):
            u = (torch.randn if self.proposal == "normal" else torch.rand)(
                shape, generator=gen, **f)
            return u if self.proposal == "normal" else 2.0 * u - 1.0

        def step(gen, state, tune: ABCTune, adapt):
            theta0 = vpack(state)
            C, dim = theta0.shape
            logprior0 = vprior(theta0, state)
            Tobs = summarize({k: state[k] for k in datakeys})
            pi0 = pi_epsilon(tune.epsilonprime, tune.epsilon,
                             distances(tune.Tsim, Tobs))
            done = torch.zeros(C, dtype=torch.bool, device=cm.device)
            theta, Tsim, eps, epsp = theta0, tune.Tsim, tune.epsilon, tune.epsilonprime
            for first in range(0, self.maxdraw, DRAWS_PER_CALL):
                if bool(done.all()):            # the one host sync of a batch
                    break
                M = min(DRAWS_PER_CALL, self.maxdraw - first)
                # M draws of every chain, all proposed from theta0: a chain's
                # draws share no state but theta0, so scoring them together
                # and keeping the first accepted one is the reference's loop
                rep = {k: v.repeat_interleave(M, 0) for k, v in state.items()}
                theta1 = (theta0[:, None] + scale * noise(gen, (C, M, dim))
                          ).reshape(C * M, dim)
                logprior1 = vprior(theta1, rep).reshape(C, M)
                Tsim1 = sim_batch(gen, {**rep, **vunpack(theta1, rep)})
                Tsim1 = Tsim1.reshape((C, M) + Tsim1.shape[1:])
                d1 = distances(Tsim1.flatten(0, 1), Tobs.repeat_interleave(M, 0)
                               ).reshape(C, M, nsim)
                eps0 = tune.epsilon[:, None]
                eps1 = ((1 - decay) * eps0
                        + decay * torch.maximum(eps_target, torch.minimum(d1, eps0)))
                epsp1 = draw_epsprime(gen, eps1)
                ratio = (pi_epsilon(epsp1, eps1, d1) / pi0[:, None]
                         * torch.exp(logprior1 - logprior0[:, None]))
                u = torch.rand((C, M), generator=gen, **f)
                acc = torch.isfinite(logprior1) & (u < ratio)
                pick = torch.argmax(acc.to(torch.int8), 1)
                take = ~done & acc.any(1)

                def first_accepted(v):
                    return v[torch.arange(C, device=v.device), pick]

                t = take[:, None]
                theta = torch.where(t, first_accepted(theta1.reshape(C, M, dim)), theta)
                Tsim = torch.where(t[..., None], first_accepted(Tsim1), Tsim)
                eps = torch.where(t, first_accepted(eps1), eps)
                epsp = torch.where(t, first_accepted(epsp1), epsp)
                done = done | take
            state = {**state, **vunpack(theta, state)}
            return state, ABCTune(Tsim=Tsim, epsilon=eps, epsilonprime=epsp)

        return BlockKernel(init, step)
