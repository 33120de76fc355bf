"""Chains persistence + BUGS/CODA import.

Counterpart of reference src/output/fileio.jl.  The reference
Julia-serializes whole ModelChains including closures (fileio.jl:3-11);
Python lambdas don't pickle, so the split here is explicit: ``write_chains``
persists draws + the resume state (the chain-stacked values, the sampler
tunes and the random generator's state, every tensor moved to the CPU), and
``read_chains`` re-binds a user-reconstructed Model on a device the caller
names to restore restartability — the same information the reference's
ModelState snapshots carry (src/Mamba.jl:152-155).

A run sharded over a mesh writes every chain's draws but only its own
rank's resume state: its chains, and on a data axis its slices of the
sites it holds in part, with the layout that cut them (``shard``).  Its
file reads back as draws, and restarting it raises: such a run restarts in
memory, on its mesh and its data layout.
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
    not the model object itself)."""
    payload = {
        "value": np.asarray(c.value), "start": c.start, "thin": c.thin,
        "names": c.names, "chains": c.chains,
    }
    if isinstance(c, ModelChains):
        payload["iter"] = c.iter
        if c.states is not None:
            payload["states"] = _tree_map(lambda t: t.detach().cpu(), c.states)
            payload["device"] = c.compiled.device.type
            payload["dtype"] = str(c.compiled.dtype).removeprefix("torch.")
            if c.compiled.comm.sharded:
                payload["shard"] = _shard_record(c)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _shard_record(mc) -> dict:
    """A sharded rank's coordinates, and the data layout of its resume
    state: for every site it holds in part, the dim and the shape of its
    slice."""
    cm = mc.compiled
    state = mc.states["state"]
    return {**cm.comm.shard_state(),
            "local": {n: {"dim": cm.local_dims[n],
                          "shape": list(state[n].shape[1:])}
                      for n in sorted(cm.local_state)}}


def read_chains(path: str, model=None, inputs=None, *, device=None,
                dtype=None):
    """Load chains written by ``write_chains`` (a file this program wrote:
    unpickling runs code).  Pass the Model, its inputs and a ``device`` to
    get a restartable ModelChains back; otherwise a plain Chains.  ``dtype``
    defaults to the one the run was written with.  A generator state only
    seeds a generator of the device type that wrote it."""
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
        if device.type != p["device"]:
            raise ValueError(
                f"the chains' generator state comes from a {p['device']} "
                f"generator and cannot seed one on {device.type}")
        dtype = dtype or getattr(torch, p["dtype"])
        example = {k: v[0].numpy() for k, v in states["state"].items()}
        cm = compile_model(model, inputs, example, device=device, dtype=dtype)

        def move(t):
            return t.to(device=device, dtype=cm.dtype if t.is_floating_point()
                        else t.dtype)

        # a generator's state stays a host tensor, whatever its device
        states = {k: v if k == "rng" else _tree_map(move, v)
                  for k, v in states.items()}
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
