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
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..output.chains import ModelChains
from .compile import CompiledModel, compile_model
from .model import Model


def _chain_inits(cm: CompiledModel, inits, chains: int):
    """Per-chain initial constrained states, chain axis first.  ``inits`` is
    a dict or a list of dicts recycled over chains (reference
    mcmc.jl:27-31)."""
    if isinstance(inits, dict):
        inits = [inits]
    stacked = {}
    for name in cm.stochastic:
        rows = []
        for k in range(chains):
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
        gen.manual_seed(777)
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
    monitored labels, the kept rows (n_kept, npar, chains) on the host and
    the timing split."""
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
    value = rows.cpu().numpy()
    fetch_s = time.perf_counter() - t0
    return state, tunes, labels, value, {"sample_s": sample_s,
                                         "fetch_s": fetch_s}


def mcmc(model_or_mc, inputs=None, inits=None, iters: int = 1000, *,
         burnin: int = 0, thin: int = 1, chains: int = 1, seed: int = 123,
         verbose: bool = True, progress: bool | None = None, dtype=None,
         device=None) -> ModelChains:
    """``mcmc(model, inputs, inits, iters; burnin, thin, chains, device)`` —
    run — or ``mcmc(mc, iters)`` — restart (reference mcmc.jl:19-33 and
    3-16).  ``device`` is required for a new run; the random stream is a
    ``torch.Generator`` on that device seeded with ``seed``."""
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

    t_setup0 = time.perf_counter()
    ex_inits = inits[0] if isinstance(inits, list) else inits
    cm = compile_model(model, inputs, ex_inits, device=device, dtype=dtype)
    kernels = _build_kernels(cm)
    state0 = _chain_inits(cm, inits, chains)
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(seed)
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
