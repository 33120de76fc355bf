"""Chains persistence + BUGS/CODA import.

Counterpart of reference src/output/fileio.jl.  The reference
Julia-serializes whole ModelChains including closures (fileio.jl:3-11);
Python lambdas don't pickle, so the split here is explicit: ``write_chains``
persists draws + the resume state (the chain-stacked values, the sampler
tunes and every chain's key, every tensor moved to the CPU), and
``read_chains`` re-binds a user-reconstructed Model on a device the caller
names to restore restartability — the same information the reference's
ModelState snapshots carry (src/Mamba.jl:152-155).

A run sharded over a mesh writes one file, as the JAX package writes its
global arrays whole: ``write_chains`` is then a collective that every rank
calls, and global rank 0 writes the draws (every rank holds them whole),
the resume state as one device would hold it (every chain, every site at
the unsharded run's shapes, the edge padding of a data axis dropped, every
per-coordinate tune in the unsharded flat order: ``MeshComm.gather_leaf``)
with every chain's key in chain order.  ``read_chains`` compiles the model
unsharded from the whole inputs the caller passes, and ``mcmc(mc, iters)``
continues it on one device, every chain on its own key: the mesh's own
continuation, as in the JAX package.  Keys are device-free, so a file
restarts on any device.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .chains import Chains, ModelChains


def _tree_map(fn, x):
    """``fn`` on every tensor of a tree of dicts, tuples, NamedTuples and
    lists; other leaves (ints, floats, None) stay as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def write_chains(path: str, c: Chains) -> None:
    """Persist a Chains/ModelChains (draws, range, names, resume state —
    not the model object itself).  For a ModelChains of a run sharded over
    a mesh, a collective: every rank calls it, and global rank 0 writes
    the one file (module docstring)."""
    payload = {
        "value": np.asarray(c.value), "start": c.start, "thin": c.thin,
        "names": c.names, "chains": c.chains,
    }
    sharded = isinstance(c, ModelChains) and c.compiled is not None \
        and c.compiled.comm.sharded
    if isinstance(c, ModelChains):
        payload["iter"] = c.iter
        if c.states is not None:
            states = c.states
            if sharded:
                states = _whole_states(c)
            payload["states"] = _tree_map(lambda t: t.detach().cpu(), states)
            payload["device"] = c.compiled.device.type
            payload["dtype"] = str(c.compiled.dtype).removeprefix("torch.")
    if not sharded:
        _dump(path, payload)
        return
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _dump(path, payload)
    dist.barrier()


def _dump(path: str, payload: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _whole_states(mc) -> dict:
    """The resume state of a sharded run's rank as one device would hold
    it (``MeshComm.gather_leaf`` leaf by leaf): every chain of every site,
    each site this data rank holds in part joined over the data group and
    its edge padding (``CompiledModel.pads``) dropped; the fields a tune
    holds per coordinate of a block that holds slices (its type's
    ``COORD_LEAVES``) joined into the unsharded flat order, those it holds
    per chain (``CHAIN_LEAVES``) joined over the chain ranks, and every
    other leaf, which every rank holds equally, kept once; every chain's
    key in chain order."""
    cm, st = mc.compiled, mc.states
    comm = cm.comm
    state = st["state"]
    chains = next(iter(state.values())).shape[0]
    whole = {}
    for n, v in state.items():
        layout = cm.local_dims.get(n) if n in cm.local_state else None
        v = comm.gather_leaf(v, f"state[{n!r}]", chains, None if layout is None
                             else {d + 1: axes for d, axes in layout.items()})
        for d, length in cm.pads.get(n, {}).items():
            v = v.narrow(d + 1, 0, length)
        whole[n] = v.clone(memory_format=torch.contiguous_format)

    def tree(x, label, per_chain=False, coords=None):
        if isinstance(x, dict):
            return {k: tree(v, f"{label}[{k!r}]") for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            lead = getattr(type(x), "CHAIN_LEAVES", ())
            per_coord = getattr(type(x), "COORD_LEAVES", ())
            return type(x)(*(tree(v, f"{label}.{f}", f in lead,
                                  coords if f in per_coord else None)
                             for f, v in zip(x._fields, x)))
        if isinstance(x, (tuple, list)):
            return type(x)(tree(v, f"{label}[{i}]") for i, v in enumerate(x))
        return comm.gather_leaf(x, label, chains if per_chain else None,
                                coords=coords)

    tunes = tuple(
        tree(t, f"tunes[{i}]", coords=cm.block_coords(s.params))
        for i, (s, t) in enumerate(zip(cm.model.samplers, st["tunes"])))
    return {"key": comm.gather_leaf(st["key"], "key", chains), "state": whole,
            "tunes": tunes, "burnin": st["burnin"]}


def read_chains(path: str, model=None, inputs=None, *, device=None,
                dtype=None):
    """Load chains written by ``write_chains`` (a file this program wrote:
    unpickling runs code).  Pass the Model, its inputs and a ``device`` to
    get a restartable ModelChains back; otherwise a plain Chains.  The file
    of a sharded run compiles unsharded here, from the whole inputs.
    ``dtype`` defaults to the one the run was written with."""
    with open(path, "rb") as f:
        p = pickle.load(f)
    if model is None:
        return Chains(p["value"], start=p["start"], thin=p["thin"],
                      names=p["names"], chains=p["chains"])
    if device is None:
        raise ValueError("read_chains needs an explicit device (e.g. 'cuda' "
                         "or 'cpu') to restore a model's chains")
    from ..model.compile import compile_model
    states = p.get("states")
    cm = None
    if states is not None and "shard" in p:
        raise ValueError(
            f"{path} was written by one rank of a sharded run ({p['shard']}): "
            f"its resume state holds that rank's chains and data slices "
            f"only, and restarts on no other layout.  Restart the run in "
            f"memory on its mesh (mcmc(mc, iters)), or read the file without "
            f"a model for its draws")
    if states is not None:
        device = torch.device(device)
        dtype = dtype or getattr(torch, p["dtype"])
        example = {k: v[0].numpy() for k, v in states["state"].items()}
        cm = compile_model(model, inputs, example, device=device, dtype=dtype)

        def move(t):
            return t.to(device=device, dtype=cm.dtype if t.is_floating_point()
                        else t.dtype)

        states = _tree_map(move, states)
    return ModelChains(p["value"], start=p["start"], thin=p["thin"],
                       names=p["names"], chains=p["chains"], model=model,
                       compiled=cm, states=states, iter=p.get("iter"))


def readcoda(output_file: str, index_file: str) -> Chains:
    """Import BUGS CODA output/index files (reference fileio.jl:14-37)."""
    out = np.loadtxt(output_file)
    names, first_ind, last_ind = [], [], []
    with open(index_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            names.append(parts[0])
            first_ind.append(int(parts[1]))
            last_ind.append(int(parts[2]))
    first_ind = np.asarray(first_ind)
    last_ind = np.asarray(last_ind)
    firstiter = out[first_ind - 1, 0].astype(int)
    lastiter = out[last_ind - 1, 0].astype(int)
    thin = int((lastiter[0] - firstiter[0]) / (last_ind[0] - first_ind[0]))
    lo, hi = firstiter.max(), lastiter.min()
    window = np.arange(lo, hi + 1, thin)
    startind = first_ind + (window[0] - firstiter) // thin
    stopind = last_ind - (lastiter - window[-1]) // thin
    value = np.empty((len(window), len(names)))
    for i in range(len(names)):
        value[:, i] = out[startind[i] - 1: stopind[i], 1]
    return Chains(value, start=int(window[0]), thin=thin, names=names)
