"""MCMC engine: all chains advance together along one chain axis.

Counterpart of reference src/model/mcmc.jl.  Where the reference farms
chains out to OS processes (mcmc.jl:36-59), here every chain-stacked state
tensor has the chain axis first and each sampler block updates all chains
at once.  The iteration loop runs on the host (the reference's loop,
mcmc.jl:62-83): burnin iterations adapt, then each kept row is written into
a preallocated device tensor that is fetched once at the end.

Restart matches the reference contract (mcmc.jl:3-16): the returned
ModelChains carries the chain-stacked values, the tunes and the random
generator's state, and ``mcmc(mc, iters)`` continues exactly.

With ``mesh`` (``parallel.make_mesh``), each rank of the mesh's chain axis
runs the loop on its block of the chains, with a generator seeded from
``(seed, chain rank)``; the ranks of a data axis run the same chains and
sum their parts of the split densities (``model/compile.py``).  Every rank
returns the full ModelChains: the kept rows are gathered over the chain
axis.  The resume state is the rank's own, so ``mcmc(mc, iters)``
continues on the same mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..output.chains import ModelChains
from ..parallel.mesh import MeshComm, pad_axes, pad_mask, rank_seed
from .compile import CompiledModel, compile_model
from .model import Model


def _chain_inits(cm: CompiledModel, inits, chains: int, first: int = 0):
    """Initial constrained states of chains ``first .. first + chains - 1``,
    chain axis first.  ``inits`` is a dict or a list of dicts recycled over
    the chains by their global index (reference mcmc.jl:27-31)."""
    if isinstance(inits, dict):
        inits = [inits]
    stacked = {}
    for name in cm.stochastic:
        rows = []
        for k in range(first, first + chains):
            d = inits[k % len(inits)]
            if name not in d:
                raise ValueError(f"chain {k}: no init for stochastic node {name!r}")
            rows.append(np.broadcast_to(
                np.asarray(d[name], dtype=np.float64), cm.sites[name].shape))
        stacked[name] = np.stack(rows)

    # NaN inits mark missing data (reference MISS semantics, miss.jl:44-52)
    nan_sites = [n for n in cm.stochastic if np.isnan(stacked[n]).any()]
    bad = [n for n in nan_sites
           if not getattr(cm.example_dists[n], "supports_imputation", True)]
    if bad:
        raise ValueError(
            f"sites {bad} have missing (NaN) values but their distribution "
            f"shares one value array across all chains (e.g. the fused "
            f"BernoulliLogitGLMM kernel) — per-chain MISS imputation would "
            f"silently evaluate every chain against chain 0's data. "
            f"Rebuild the model with the generic likelihood (fused=False).")
    state = {n: cm.tensor(v) for n, v in stacked.items()}
    if nan_sites:
        # prior-impute them before the first iteration so kernel
        # initialization sees finite log-densities; the draws come from a
        # generator of their own, so the run's stream does not depend on
        # whether there were values to impute
        gen = torch.Generator(device=cm.device)
        gen.manual_seed(rank_seed(777, cm.comm.chain_rank))
        filled = {n: torch.nan_to_num(v) for n, v in state.items()}
        draws = cm.forward_sample(gen, filled, names=nan_sites)
        for n in nan_sites:
            state[n] = torch.where(torch.isnan(state[n]), draws[n], state[n])
    return state


def _build_kernels(cm: CompiledModel):
    specs = cm.model.samplers
    if not specs:
        raise ValueError("model has no sampler blocks; call set_samplers first")
    return [s.build(cm) for s in specs]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(cm, kernels, gen, state, tunes, burnin, n_kept, thin, meter):
    """Warmup then kept iterations; returns the final (state, tunes), the
    monitored labels, the kept rows (n_kept, npar, chains) of every chain
    rank on the host and the timing split."""
    _, labels, pack_monitored = cm.monitor_spec()
    pack_rows = torch.func.vmap(pack_monitored)
    chains = next(iter(state.values())).shape[0]
    rows = torch.empty((n_kept, len(labels), chains), dtype=cm.dtype,
                       device=cm.device)

    def gibbs_iter(state, tunes, adapt):
        new_tunes = []
        for k, tune in zip(kernels, tunes):
            state, t = k.step(gen, state, tune, adapt)
            new_tunes.append(t)
        if meter is not None:
            meter.update(1)
        return state, tuple(new_tunes)

    _sync(cm.device)
    t0 = time.perf_counter()
    for _ in range(burnin):
        state, tunes = gibbs_iter(state, tunes, True)
    for i in range(n_kept):
        for _ in range(thin):
            state, tunes = gibbs_iter(state, tunes, False)
        rows[i] = pack_rows(state).T
    _sync(cm.device)
    sample_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    value = cm.comm.gather_chains(rows, dim=2).cpu().numpy()
    fetch_s = time.perf_counter() - t0
    return state, tunes, labels, value, {"sample_s": sample_s,
                                         "fetch_s": fetch_s}


def mcmc(model_or_mc, inputs=None, inits=None, iters: int = 1000, *,
         burnin: int = 0, thin: int = 1, chains: int = 1, seed: int = 123,
         verbose: bool = True, progress: bool | None = None, dtype=None,
         device=None, mesh=None, chain_axis: str = "chains",
         site_specs: dict | None = None) -> ModelChains:
    """``mcmc(model, inputs, inits, iters; burnin, thin, chains, device)`` —
    run — or ``mcmc(mc, iters)`` — restart (reference mcmc.jl:19-33 and
    3-16).  ``device`` is required for a new run; the random stream is a
    ``torch.Generator`` on that device seeded with ``seed``.

    ``mesh`` (a ``DeviceMesh`` with a ``chain_axis`` and at most one data
    axis) shards the chains over its chain axis: ``chains`` must divide by
    it, and each chain rank's generator is seeded from ``(seed, chain
    rank)`` (``parallel.mesh.rank_seed``).  ``site_specs`` maps site names
    to per-dim specs (None, or mesh axis names, e.g. ``{"y": ("data",)}``):
    an observed site sharded over the data axis is split between its
    ranks, each summing its slice of the likelihood; a dim the axis does
    not divide is edge-padded and masked out (reference semantics); sampled
    sites named there are replicated."""
    if isinstance(model_or_mc, ModelChains):
        return _mcmc_restart(model_or_mc, inputs if inputs is not None else iters,
                             verbose=verbose, progress=progress)
    model = model_or_mc
    if not isinstance(model, Model):
        raise TypeError("first argument must be a Model or a ModelChains")
    if device is None:
        raise ValueError("mcmc needs an explicit device (e.g. 'cuda' or 'cpu')")
    if iters <= burnin:
        raise ValueError("iters must exceed burnin")
    n_kept = (iters - burnin) // thin
    comm = MeshComm(mesh, chain_axis)
    local = comm.local_chains(chains)

    t_setup0 = time.perf_counter()
    masks = None
    if mesh is not None and site_specs:
        inputs, inits, masks = _pad_sharded(model, mesh, site_specs,
                                            inputs or {}, inits)
    ex_inits = inits[0] if isinstance(inits, list) else inits
    cm = compile_model(model, inputs, ex_inits, device=device, dtype=dtype,
                       masks=masks, comm=comm, site_specs=site_specs)
    kernels = _build_kernels(cm)
    state0 = _chain_inits(cm, inits, local, first=comm.chain_rank * local)
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(rank_seed(seed, comm.chain_rank))
    tunes0 = tuple(k.init(gen, state0) for k in kernels)
    _sync(cm.device)
    setup_s = time.perf_counter() - t_setup0

    meter = _meter(verbose, progress, burnin + n_kept * thin, chains)
    state_f, tunes_f, labels, value, timing = _run(
        cm, kernels, gen, state0, tunes0, burnin, n_kept, thin, meter)
    timing["setup_s"] = setup_s
    if verbose:
        print(f"MCMC: {chains} chains x {iters} iterations "
              f"({burnin} burnin, thin {thin}) in {timing['sample_s']:.2f}s "
              f"({chains * iters / max(timing['sample_s'], 1e-9):,.0f} "
              f"chain-iters/s; draw fetch {timing['fetch_s']:.2f}s)")
    return ModelChains(
        value, start=burnin + thin, thin=thin, names=labels,
        chains=list(range(1, chains + 1)), model=model, compiled=cm,
        states={"rng": gen.get_state(), "state": state_f, "tunes": tunes_f,
                "burnin": burnin}, iter=burnin + n_kept * thin,
        timing=timing)


def _pad_sharded(model, mesh, site_specs, inputs, inits):
    """Edge-pad every array that ``site_specs`` shards on a dim its mesh
    axes do not divide, and mask the padded entries of stochastic sites
    out of the likelihood (the JAX package's mcmc, model/mcmc.py:366-412).
    Returns the padded inputs and inits and the masks."""
    inputs, _ = pad_axes(mesh, site_specs, inputs)
    padded, pads = [], {}
    for d in (inits if isinstance(inits, list) else [inits]):
        pd, pads_d = pad_axes(mesh, site_specs, d)
        padded.append(pd)
        pads.update(pads_d)
    stoch = set(model.keys("stochastic"))
    bad = sorted(set(pads) & stoch & set(model.keys("monitor")))
    if bad:
        raise ValueError(
            f"sites {bad} are sharded on a non-divisible axis and "
            f"monitored; set monitor=False (padded elements would "
            f"appear in the output) or pad the data yourself")
    sampled_bad = sorted((set(pads) & stoch) - set(model.keys("observed")))
    if sampled_bad:
        # a masked coordinate has zero gradient: under HMC momentum it
        # random-walks without bound and can overflow through a bijector
        raise ValueError(
            f"sampled sites {sampled_bad} are sharded on a non-divisible "
            f"mesh axis; pad-and-mask is only valid for observed data sites "
            f"(padded sampled coordinates would drift unboundedly). Make the "
            f"axis divisible or shard a different dimension.")
    masks = {n: pad_mask(np.asarray(padded[0][n]).shape, p)
             for n, p in pads.items() if n in stoch}
    return inputs, padded, masks


def _meter(verbose, progress, total, chains):
    """Default-on ETA progress meter (reference default verbose=true shows
    ChainProgress, mcmc.jl:44-51)."""
    if not (verbose if progress is None else progress):
        return None
    from ..utils.progress import ChainProgress
    return ChainProgress(total, chains=chains)


def _mcmc_restart(mc: ModelChains, iters: int, *, verbose=True,
                  progress=None) -> ModelChains:
    """Continue a run from its stored per-chain state (reference
    mcmc.jl:3-16): tune state, values and the generator state carry over;
    the new draws are appended with a contiguous iteration range."""
    if mc.compiled is None or mc.states is None:
        raise ValueError("ModelChains lacks resume state")
    cm = mc.compiled
    kernels = _build_kernels(cm)
    thin = mc.thin
    n_kept = iters // thin
    if n_kept < 1:
        raise ValueError("iters too small for one kept sample at current thin")
    st = mc.states
    gen = torch.Generator(device=cm.device)
    gen.set_state(st["rng"])
    meter = _meter(verbose, progress, n_kept * thin, mc.nchains)
    state_f, tunes_f, labels, value, timing = _run(
        cm, kernels, gen, st["state"], st["tunes"], 0, n_kept, thin, meter)
    new = ModelChains(
        value, start=mc.iter + thin, thin=thin, names=labels,
        chains=mc.chains, model=mc.model, compiled=cm,
        states={"rng": gen.get_state(), "state": state_f, "tunes": tunes_f,
                "burnin": st["burnin"]}, iter=mc.iter + n_kept * thin,
        timing=timing)
    out = mc.cat_iters(new)
    out.states, out.iter, out.compiled, out.model = new.states, new.iter, cm, mc.model
    out.timing = timing
    return out
