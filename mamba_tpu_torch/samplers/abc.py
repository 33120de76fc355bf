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
up to ``DRAWS_PER_CALL`` of them are scored at once for every chain (one
simulation call for all of them) and the first accepted one is kept: the
same draws as one at a time, at a fraction of the calls.  The batches are
bodies (``utils.graphs.Captured``) that the engine replays from CUDA
graphs: the first holds the step's set-up and ``maxdraw``'s remainder
(``maxdraw - DRAWS_PER_CALL * (batches - 1)`` draws, 1 to
``DRAWS_PER_CALL``), each later one ``DRAWS_PER_CALL`` draws, so a block
has at most two bodies.  The host tests a device flag once per batch, to
stop when every chain has accepted (``graphs.until_done``).  A body draws
from the block's per-chain keys, which the step loads into the buffer
``key``: batch ``j`` of a step draws from ``fold_in(key, j)``, ``j`` a
counter on the device that the body advances in place, so a replay draws
the next batch's numbers and a chain's numbers do not depend on how many
batches the other chains need.  The simulations draw inside the
distributions' ``sample``.  The plain loop runs the same bodies eagerly.

Proposals are made in the block's link-transformed space, like the
reference (unlist/relist with transform=true, abc.jl:45, 103-110).  On a
mesh's data axis the summaries read the observed and simulated data whole:
each data rank gathers its slices (``cm.whole``) before summarizing, and
each gather cuts the captured bodies (``utils.graphs.cut``).  ``summary``
and ``dist`` run inside the
captured bodies: a user function that waits for the device or copies from
the host fails the capture, with ``graphs``' message, which names
``utils.graphs.disabled()``.

Random draws, each from its own key (``ops/random.py``): at init, from
the chain keys split in two, the nsim simulations and, with ``randeps``,
the tolerances ``(C, nsim)`` (exponential); per batch of M draws in a
step, from the batch's keys folded with 0 to 3, the proposals ``(C, M,
dim)``, the simulations (a key split off per draw and per simulation), the
tolerances ``(C, M, nsim)`` with ``randeps``, and the acceptance uniforms
``(C, M)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import random as R
from ..utils import graphs
from .base import BlockKernel, SamplerSpec, drawing

#: draws of the ``maxdraw`` loop scored together, per chain
DRAWS_PER_CALL = 25


class ABCTune(NamedTuple):
    Tsim: torch.Tensor          # (C, nsim, Tdim) summaries at the current values
    epsilon: torch.Tensor       # (C, nsim) tolerances
    epsilonprime: torch.Tensor  # (C, nsim) randomized tolerances
    #: the fields held per chain, chain axis first (a sharded run's chain
    #: file joins them over the chain ranks: ``output.fileio``)
    CHAIN_LEAVES = ("Tsim", "epsilon", "epsilonprime")


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
        vpack, vunpack = cm.block_maps(self.params, True, prior_only=True)
        vprior = cm.block_density(self.params, True, prior_only=True)
        prepare = cm.block_prepare(self.params, prior_only=True)
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

        vsummary = torch.func.vmap(one_summary)

        def summarize(values):
            # the summaries read the data whole: a data rank gathers its
            # slices over the data group first
            return vsummary({k: cm.whole(k, values[k], 1) for k in datakeys})
        distances = torch.func.vmap(torch.func.vmap(self.dist, in_dims=(0, None)))

        def per_row(key, m):
            """``m`` keys per row of ``key (C, 2)``, as ``(C * m, 2)`` in
            the order of ``repeat_interleave(m, 0)``."""
            return R.split(key, m).transpose(0, 1).reshape(-1, 2)

        def sim_batch(key, state):
            """(C, nsim, Tdim) summaries of nsim simulations per chain."""
            C = next(iter(state.values())).shape[0]
            rep = {k: v.repeat_interleave(nsim, 0) for k, v in state.items()}
            sim = cm.forward_sample(per_row(key, nsim), rep, names=datakeys)
            T = summarize({k: sim[k] for k in datakeys})
            return T.reshape((C, nsim) + T.shape[1:])

        def pi_epsilon(epsp, eps, d):
            logk = _kernel_logpdf(self.kernel, epsp, d)
            if self.randeps:
                logk = logk - epsp / eps - torch.log(eps)   # Exponential(eps) pdf
            return torch.sum(torch.exp(logk), -1)

        def draw_epsprime(key, eps, fold=None):
            if not self.randeps:
                return eps
            u = R.uniform(key, eps.shape[1:], cm.dtype, fold=fold)
            return -eps * torch.log1p(-u)

        def init(key, state):
            Tobs = summarize({k: state[k] for k in datakeys})
            ks, ke = R.split(key)
            Tsim = sim_batch(ks, state)
            d = distances(Tsim, Tobs)
            eps = (torch.maximum(eps_target, d) if decay > 0
                   else torch.full(d.shape, self.epsilon, **f))
            return ABCTune(Tsim=Tsim, epsilon=eps,
                           epsilonprime=draw_epsprime(ke, eps))

        def noise(key, shape):
            draw = R.normal if self.proposal == "normal" else R.uniform
            u = draw(key, shape, cm.dtype, fold=0)
            return u if self.proposal == "normal" else 2.0 * u - 1.0

        def first(b, state, M):
            """The step's set-up, then its first batch, of ``M`` draws."""
            b["logprior0"].copy_(vprior(b["theta0"], state))
            Tobs = summarize({k: state[k] for k in datakeys})
            b["Tobs"].copy_(Tobs)
            b["pi0"].copy_(pi_epsilon(b["epsp0"], b["eps0"],
                                      distances(b["Tsim0"], Tobs)))
            for k in ("theta", "Tsim", "eps", "epsp"):
                b[k].copy_(b[k + "0"])
            b["done"].zero_()
            b["round"].zero_()
            batch(b, state, M)

        def batch(b, state, M):
            """``M`` draws of every chain, all proposed from theta0: a
            chain's draws share no state but theta0, so scoring them
            together and keeping the first accepted one is the reference's
            loop."""
            theta0, done = b["theta0"], b["done"]
            C, dim = theta0.shape
            key = R.fold_in(b["key"], b["round"])
            b["round"].add_(1)
            rep = {k: v.repeat_interleave(M, 0) for k, v in state.items()}
            theta1 = (theta0[:, None] + scale * noise(key, (M, dim))
                      ).reshape(C * M, dim)
            logprior1 = vprior(theta1, rep).reshape(C, M)
            Tsim1 = sim_batch(per_row(R.fold_in(key, 1), M),
                              {**rep, **vunpack(theta1, rep)})
            Tsim1 = Tsim1.reshape((C, M) + Tsim1.shape[1:])
            d1 = distances(Tsim1.flatten(0, 1), b["Tobs"].repeat_interleave(M, 0)
                           ).reshape(C, M, nsim)
            eps0 = b["eps0"][:, None]
            eps1 = ((1 - decay) * eps0
                    + decay * torch.maximum(eps_target, torch.minimum(d1, eps0)))
            epsp1 = draw_epsprime(key, eps1, fold=2)
            ratio = (pi_epsilon(epsp1, eps1, d1) / b["pi0"][:, None]
                     * torch.exp(logprior1 - b["logprior0"][:, None]))
            u = R.uniform(key, (M,), cm.dtype, fold=3)
            acc = torch.isfinite(logprior1) & (u < ratio)
            pick = torch.argmax(acc.to(torch.int8), 1)
            take = ~done & acc.any(1)

            def first_accepted(v):
                return v[torch.arange(C, device=v.device), pick]

            t = take[:, None]
            b["theta"].copy_(torch.where(
                t, first_accepted(theta1.reshape(C, M, dim)), b["theta"]))
            b["Tsim"].copy_(torch.where(t[..., None], first_accepted(Tsim1),
                                        b["Tsim"]))
            b["eps"].copy_(torch.where(t, first_accepted(eps1), b["eps"]))
            b["epsp"].copy_(torch.where(t, first_accepted(epsp1), b["epsp"]))
            done.copy_(done | take)
            b["more"].copy_(~done.all())

        # the batches: maxdraw's remainder first (with the set-up), then
        # full ones; one body each
        batches = -(-self.maxdraw // DRAWS_PER_CALL)
        rest = self.maxdraw - DRAWS_PER_CALL * (batches - 1)

        bodies = {"first": lambda b, s: first(b, s, rest),
                  "more": lambda b, s: batch(b, s, DRAWS_PER_CALL)}
        cap = drawing(bodies, eager=not graphs.enabled())

        def step(key, state, tune: ABCTune, adapt):
            theta0 = vpack(state)
            C = theta0.shape[0]
            cap.load_state(prepare(state))
            if not cap.holds("Tsim0", tune.Tsim) or not cap.holds("theta0", theta0):
                flag = dict(dtype=torch.bool, device=cm.device)
                cap.load(theta=theta0, Tsim=tune.Tsim, eps=tune.epsilon,
                         epsp=tune.epsilonprime, logprior0=theta0[:, 0],
                         pi0=theta0[:, 0], Tobs=tune.Tsim[:, 0],
                         done=torch.zeros(C, **flag),
                         more=torch.zeros((), **flag),
                         round=torch.zeros(1, dtype=torch.int64,
                                           device=cm.device))
            cap.load(theta0=theta0, Tsim0=tune.Tsim, eps0=tune.epsilon,
                     epsp0=tune.epsilonprime, key=key)
            graphs.until_done(cap, "first", "more", batches)
            b = cap.bufs
            state = {**state, **vunpack(b["theta"].clone(), state)}
            return state, ABCTune(Tsim=b["Tsim"].clone(), epsilon=b["eps"].clone(),
                                  epsilonprime=b["epsp"].clone())

        return BlockKernel(init, step)
