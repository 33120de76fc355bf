"""MCMC engine: all chains advance together along one chain axis.

Counterpart of reference src/model/mcmc.jl.  Where the reference farms
chains out to OS processes (mcmc.jl:36-59), here every chain-stacked state
tensor has the chain axis first and each sampler block updates all chains
at once.  The iteration loop runs on the host (the reference's loop,
mcmc.jl:62-83): burnin iterations adapt, then each kept row is written into
a preallocated device tensor that is fetched once at the end.  The JAX
engine compiles each phase into one program; here the loop stays on the
host, and the samplers' steps are replayed from CUDA graphs
(``utils/graphs.py``), captured at their first step: NUTS's leaves, the
leapfrogs of ChEES and HMC, DGS's sweeps, the shrink trips of Slice (both
forms) and SliceSimplex, AMWG's sweeps, BHMC's wall hits, the whole step
of RWM, AMM, MALA, BIA, BMC3 and BMG, ABC's batches of draws, MISS's
imputations and a Gibbs block's call of its user ``fn``, as the JAX engine
traces that ``fn`` into its program (a ``fn`` that cannot be captured
raises; ``utils.graphs.disabled()`` runs it eagerly).  A loop that runs
until no chain is left (a slice sampler's shrink trips, BHMC's wall hits,
ABC's retries) tests a device flag on the host once per batch.  On a CUDA
device ``timing`` reports the graphs a run captured (``graphs``, the
Gibbs blocks' among them; a body cut at its collectives on a mesh's data
axis counts one per segment), the seconds their captures took
(``capture_s``, part of ``sample_s``), the replays (one per segment), the
host tests (``host_tests``), and the collectives run between replays
(``collectives``) with their host seconds (``collective_s``) and their
count per group of mesh axes (``group_collectives``).

Random numbers come from per-chain threefry keys (``ops/random.py``), as
in the JAX package: chain ``i`` (its global index) starts from
``fold_in(key(seed), i)``, every sampler's tune starts from that key, and
each iteration takes ``key, sub = split(key)`` per block and gives the
block ``sub``.  A chain's draws therefore do not depend on the mesh, nor
on the other chains.

Restart matches the reference contract (mcmc.jl:3-16): the returned
ModelChains carries the chain-stacked values, the tunes and every chain's
key, and ``mcmc(mc, iters)`` continues exactly.

With ``mesh`` (``parallel.make_mesh``), each rank of the mesh's chain axis
runs the loop on its block of the chains, each chain on its own key; the
ranks of the data axes (every other axis: a data group) run the same
chains and sum their parts of the split densities (``model/compile.py``).
Each data rank holds only its block of the inputs and sites that
``site_specs`` names on the data axes, as GSPMD does in the JAX package:
a spec's entry is None, one axis or a tuple of axes, and a value cut over
some of the data axes is replicated over the others; a named
*sampled* site too where every block that samples it can hold slices
(NUTS, ChEES-HMC, HMC and MALA with unit mass) and the compiler finds it
read only as a slice; such a block sums over its coordinates across the
data group.  Any other named sampled site stays whole in the state, and
the density reads its slice.  Every rank
returns the full ModelChains: the kept rows are gathered over the data
group (the rows of nodes a rank holds in part, sampled sites held as
slices too) and over the chain axis.
The resume state is the rank's own, so ``mcmc(mc, iters)`` continues on
the same mesh; ``write_chains`` writes it whole, every chain's key with
it, and the file restarts on one device with every chain on its own
stream, as the JAX package's does.  On a CUDA device ``timing`` also gives
the rise of the run's peak allocated memory over what was allocated at
its start (``peak_rise_bytes``): the run resets the device's peak
statistics (``torch.cuda.reset_peak_memory_stats``) when it starts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..output.chains import ModelChains
from ..ops import random as R
from ..parallel.mesh import MeshComm, pad_axes, pad_mask
from ..utils import graphs
from .compile import CompiledModel, compile_model
from .model import Model


def _chain_inits(cm: CompiledModel, inits, chains: int, first: int = 0):
    """Initial constrained states of chains ``first .. first + chains - 1``,
    chain axis first.  ``inits`` is a dict or a list of dicts recycled over
    the chains by their global index (reference mcmc.jl:27-31).  A site this
    data rank holds in part (``cm.local_state``) is stacked as its slice."""
    if isinstance(inits, dict):
        inits = [inits]
    stacked, nan_sites = {}, []
    for name in cm.stochastic:
        rows = []
        for k in range(first, first + chains):
            d = inits[k % len(inits)]
            if name not in d:
                raise ValueError(f"chain {k}: no init for stochastic node {name!r}")
            row = np.broadcast_to(np.asarray(d[name], dtype=np.float64),
                                  cm.sites[name].shape)
            given = cm.example_values.get(name)
            if name in cm.const_data and not np.array_equal(
                    row.astype(given.dtype), given, equal_nan=True):
                raise ValueError(
                    f"chain {k}: the data {name!r} differ from the first "
                    f"init's, which a data rank's constants were computed "
                    f"from once (model/compile.py); give every chain the "
                    f"same data")
            # NaN inits mark missing data (reference MISS semantics,
            # miss.jl:44-52); every data rank finds them in the whole value
            if name not in nan_sites and np.isnan(row).any():
                nan_sites.append(name)
            rows.append(cm.local(name, row))
        stacked[name] = np.stack(rows)

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
        # initialization sees finite log-densities; the draws come from
        # keys of their own, fold_in(key(777), i) for global chain i, so
        # the run's keys do not depend on whether there were values to
        # impute (the JAX package's _chain_inits)
        keys = R.chain_keys(777, range(first, first + chains), cm.device)
        filled = {n: torch.nan_to_num(v) for n, v in state.items()}
        draws = cm.forward_sample(keys, filled, names=nan_sites)
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


def _run(cm, kernels, keys, state, tunes, burnin, n_kept, thin, meter):
    """Warmup then kept iterations from the per-chain ``keys``; returns the
    final (keys, state, tunes), the monitored labels, the kept rows
    (n_kept, npar, chains) of every chain rank on the host and the timing
    split."""
    _, labels, _ = cm.monitor_spec()
    pack_rows = cm.monitor_rows()
    chains = next(iter(state.values())).shape[0]
    rows = torch.empty((n_kept, cm.monitor_width(), chains), dtype=cm.dtype,
                       device=cm.device)

    def gibbs_iter(keys, state, tunes, adapt):
        new_tunes = []
        for k, tune in zip(kernels, tunes):
            keys, sub = R.split(keys)
            state, t = k.step(sub, state, tune, adapt)
            new_tunes.append(t)
        if meter is not None:
            meter.update(1)
        return keys, state, tuple(new_tunes)

    _sync(cm.device)
    graphs0 = dict(graphs.STATS)
    groups0 = dict(graphs.GROUP_COLLECTIVES)
    t0 = time.perf_counter()
    for _ in range(burnin):
        keys, state, tunes = gibbs_iter(keys, state, tunes, True)
    for i in range(n_kept):
        for _ in range(thin):
            keys, state, tunes = gibbs_iter(keys, state, tunes, False)
        rows[i] = pack_rows(state).T
    _sync(cm.device)
    sample_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    value = cm.comm.gather_chains(cm.gather_monitored(rows), dim=2)
    value = value.cpu().numpy()
    fetch_s = time.perf_counter() - t0
    timing = {"sample_s": sample_s, "fetch_s": fetch_s}
    if cm.device.type == "cuda":
        # graphs captured in this run (at a sampler's first step, inside
        # sample_s; a body cut at its collectives counts one per segment),
        # the seconds their captures took, warm-ups included, the replays
        # (one per segment), the host tests of a device flag, and the
        # collectives run between replays with their host seconds, and
        # those per group of mesh axes (``"data,week"``)
        timing.update({k: graphs.STATS[k] - graphs0[k] for k in graphs0})
        timing["group_collectives"] = {
            ",".join(g): n - groups0.get(g, 0)
            for g, n in graphs.GROUP_COLLECTIVES.items()
            if n != groups0.get(g, 0)}
    return keys, state, tunes, labels, value, timing


def _memory_start(device: torch.device):
    """Reset the device's peak statistics at a run's start; the bytes
    allocated then (None off CUDA)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _memory_timing(device: torch.device, before) -> dict:
    """The rise of the run's peak allocated bytes over ``before``."""
    if before is None:
        return {}
    return {"peak_rise_bytes": torch.cuda.max_memory_allocated(device) - before}


def mcmc(model_or_mc, inputs=None, inits=None, iters: int = 1000, *,
         burnin: int = 0, thin: int = 1, chains: int = 1, seed: int = 123,
         verbose: bool = True, progress: bool | None = None, dtype=None,
         device=None, mesh=None, chain_axis: str = "chains",
         site_specs: dict | None = None) -> ModelChains:
    """``mcmc(model, inputs, inits, iters; burnin, thin, chains, device)`` —
    run — or ``mcmc(mc, iters)`` — restart (reference mcmc.jl:19-33 and
    3-16).  ``device`` is required for a new run; chain ``i`` draws from
    ``fold_in(key(seed), i)`` on that device.

    ``mesh`` (a ``DeviceMesh`` with a ``chain_axis`` and any number of
    data axes) shards the chains over its chain axis: ``chains`` must
    divide by it, and each rank keys its chains by their global indices,
    so the run draws the numbers of the run without a mesh.
    ``site_specs`` maps site names to per-dim specs, as a ``PartitionSpec``
    takes them (None, an axis name or a tuple of them, e.g. ``{"y":
    ("data", "week")}`` or ``{"y": (None, ("data", "obs"))}``): each data
    rank holds and evaluates its block of every input and site named on
    the data axes (a sampled site stays whole in the state where a block
    that samples it cannot hold slices, or the compiler finds it read
    whole: ``model/compile.py``); each dim its axes do not divide is
    edge-padded and masked out (reference semantics).  The data axis takes what GSPMD takes: a node that reads
    a whole value as the rank's slice of it (the GLMM with only y and its
    covariates named reads its slice of the whole b), a density term that
    reads a node computed from the chain state and slices (each rank
    gathers that node's leaves and computes it whole: once per step, or
    once per density call of a block that moves them, also where the
    node reads a slice computed from another gathered node), a named term
    that reads such a node (the sum-to-zero effect ``b = sqrt(s2) * (z -
    mean(z))``, y's groups reading their slice of it: the block sums its
    gradient in the gathered leaves over the data group before each rank
    pulls its slice back), a named site whose data dims cut an event of
    its law (jaws' ``BDiagNormal`` cut by boy: the term is computed whole
    from the whole values, as GSPMD gathers the event), and a value
    computed from an array the axis pads, which is computed from the
    array as given (each node's padding its own record), so the run is
    the unsharded run's.  What stays refused, with a ValueError that names
    it: what ``NamedSharding`` refuses (the chain axis in a spec, an axis
    on two dims) and what the compiler cannot confirm at its probe
    state."""
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

    mem0 = _memory_start(torch.device(device))
    t_setup0 = time.perf_counter()
    masks = pads = None
    if mesh is not None and site_specs:
        inputs, inits, masks, pads = _pad_sharded(model, mesh, site_specs,
                                                  inputs or {}, inits)
    ex_inits = inits[0] if isinstance(inits, list) else inits
    cm = compile_model(model, inputs, ex_inits, device=device, dtype=dtype,
                       masks=masks, comm=comm, site_specs=site_specs,
                       pads=pads)
    kernels = _build_kernels(cm)
    first = comm.chain_rank * local
    state0 = _chain_inits(cm, inits, local, first=first)
    keys = R.chain_keys(seed, range(first, first + local), cm.device)
    tunes0 = tuple(k.init(keys, state0) for k in kernels)
    _sync(cm.device)
    setup_s = time.perf_counter() - t_setup0

    meter = _meter(verbose, progress, burnin + n_kept * thin, chains)
    keys_f, state_f, tunes_f, labels, value, timing = _run(
        cm, kernels, keys, state0, tunes0, burnin, n_kept, thin, meter)
    timing["setup_s"] = setup_s
    timing.update(_memory_timing(cm.device, mem0))
    if verbose:
        print(f"MCMC: {chains} chains x {iters} iterations "
              f"({burnin} burnin, thin {thin}) in {timing['sample_s']:.2f}s "
              f"({chains * iters / max(timing['sample_s'], 1e-9):,.0f} "
              f"chain-iters/s; draw fetch {timing['fetch_s']:.2f}s)")
    return ModelChains(
        value, start=burnin + thin, thin=thin, names=labels,
        chains=list(range(1, chains + 1)), model=model, compiled=cm,
        states={"key": keys_f, "state": state_f, "tunes": tunes_f,
                "burnin": burnin}, iter=burnin + n_kept * thin,
        timing=timing)


def _pad_sharded(model, mesh, site_specs, inputs, inits):
    """Edge-pad every array that ``site_specs`` shards on a dim its mesh
    axes do not divide, and mask the padded entries of stochastic sites
    out of the likelihood (the JAX package's mcmc, model/mcmc.py:366-412).
    Returns the padded inputs and inits, the masks, and per padded input
    or site each padded dim's length as given."""
    inputs, pads = pad_axes(mesh, site_specs, inputs)
    padded = []
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
    given = {n: {d: g for d, (g, _) in p.items()} for n, p in pads.items()}
    return inputs, padded, masks, given


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
    mcmc.jl:3-16): tune state, values and every chain's key carry over;
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
    moved = sorted(n for n, v in st["state"].items()
                   if tuple(v.shape[1:]) != cm.local_shape(n))
    if moved:
        raise ValueError(
            f"the resume state's {moved} do not have this rank's data layout "
            f"({ {n: cm.local_shape(n) for n in moved} }): a run restarts on "
            f"the mesh and site_specs it ran on")
    mem0 = _memory_start(cm.device)
    meter = _meter(verbose, progress, n_kept * thin, mc.nchains)
    keys_f, state_f, tunes_f, labels, value, timing = _run(
        cm, kernels, st["key"], st["state"], st["tunes"], 0, n_kept, thin,
        meter)
    timing.update(_memory_timing(cm.device, mem0))
    new = ModelChains(
        value, start=mc.iter + thin, thin=thin, names=labels,
        chains=mc.chains, model=mc.model, compiled=cm,
        states={"key": keys_f, "state": state_f, "tunes": tunes_f,
                "burnin": st["burnin"]}, iter=mc.iter + n_kept * thin,
        timing=timing)
    out = mc.cat_iters(new)
    out.states, out.iter, out.compiled, out.model = new.states, new.iter, cm, mc.model
    out.timing = timing
    return out
