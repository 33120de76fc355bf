"""Model-based posterior statistics: DIC, posterior-predictive draws, and
log-density over stored draws.

Counterpart of reference src/output/modelstats.jl.  The reference re-walks
the interpreted graph per stored draw per chain, farming chains to
processes (modelstats.jl:30-68); here every stored draw of every chain is
one row of a single flattened (chains x draws) batch: the draw states are
rebuilt from the stored columns on top of each chain's final state and
evaluated by one ``torch.func.vmap`` over that batch.  One level of
``vmap``, never two, so a likelihood with a chain-batched ``vmap`` rule (the
fused GLMM kernel) sees one batch of chains x draws.  Predictive draws come
from ``forward_sample`` on the same flattened batch, from a generator of
their own.

Requires every *sampled* stochastic node to be monitored (the reference has
the same practical requirement: relist reads stored columns).
"""

from __future__ import annotations

import numpy as np
import torch

from .chains import Chains, ModelChains
from .chainsummary import ChainSummary
from .stats import _header


def _site_columns(mc: ModelChains):
    """Column index ranges of each stored site, in monitor-spec order."""
    cm = mc.compiled
    monitored, labels, _ = cm.monitor_spec()
    if labels != mc.names:
        raise ValueError("chain columns do not match the model's monitor spec")
    cols = {}
    off = 0
    for n in monitored:
        shape = cm.sites[n].shape if n in cm.sites else cm.logical_shapes[n]
        size = int(np.prod(shape)) if shape else 1
        idx = cm.model.nodes[n].monitor_indices(size)
        if idx is None:
            cols[n] = (off, shape)
            off += size
        else:
            # partially-monitored nodes can't be reconstructed from storage
            off += len(idx)
    return cols


def _unpack_site(flat_cols: torch.Tensor, shape):
    """Invert the engine's column-major (Julia ``vec``) flattening of the
    last axis into ``shape``."""
    if not shape:
        return flat_cols[..., 0]
    if len(shape) == 1:
        return flat_cols
    lead = flat_cols.dim() - 1
    rev = flat_cols.reshape(tuple(flat_cols.shape[:-1]) + tuple(reversed(shape)))
    return rev.permute(*range(lead), *(lead + i for i in reversed(range(len(shape)))))


def _draw_state_fn(mc: ModelChains):
    """``fn(row, base) -> state``: one stored draw's full site state, the
    stored sites from ``row`` and everything else from ``base``, one chain's
    final state."""
    cm = mc.compiled
    cols = _site_columns(mc)
    stored_stoch = [n for n in cm.stochastic if n in cols]
    observed = set(mc.model.keys("observed")) if mc.model.samplers else set()
    sampled = set(mc.model.keys("sampled"))
    missing = [n for n in cm.stochastic
               if n not in cols and n not in observed and n in sampled]
    if missing:
        raise ValueError(
            f"sampled nodes {missing} are not monitored; model-based stats "
            "need their stored draws")

    def fn(row, base):
        state = dict(base)
        for n in stored_stoch:
            off, shape = cols[n]
            size = int(np.prod(shape)) if shape else 1
            state[n] = _unpack_site(row[..., off:off + size], shape).to(cm.dtype)
        return state

    return fn


def _flat_batch(mc: ModelChains):
    """The stored draws as one batch, chain-major (row ``k * niter + i`` is
    draw i of chain k): ``(rows (C*n, p), bases)``, where ``bases`` repeats
    each chain's final state (``mc.states["state"]``, chain-stacked) over
    its draws."""
    cm = mc.compiled
    n = mc.niter
    rows = cm.tensor(np.ascontiguousarray(mc.value.transpose(2, 0, 1)))
    rows = rows.reshape(mc.nchains * n, mc.nparams)
    bases = {k: v.repeat_interleave(n, dim=0)
             for k, v in mc.states["state"].items()}
    return rows, bases


def logpdf_chains(mc: ModelChains, nodekeys=None) -> Chains:
    """Per-draw total log-density (reference logpdf(mc), modelstats.jl:30-68)
    as a 1-parameter Chains named 'logpdf'."""
    cm = mc.compiled
    if nodekeys is None:
        nodekeys = cm.stochastic
    elif isinstance(nodekeys, str):
        nodekeys = [nodekeys]
    draw_state = _draw_state_fn(mc)
    terms = tuple(nodekeys)
    rows, bases = _flat_batch(mc)
    vals = torch.func.vmap(
        lambda row, base: cm.logpdf(draw_state(row, base), terms=terms))(
        rows, bases)
    vals = vals.reshape(mc.nchains, mc.niter).detach().cpu().numpy()
    return Chains(vals.T[:, None, :], start=mc.start, thin=mc.thin,
                  names=["logpdf"], chains=mc.chains)


def logpdf_at(mc: ModelChains, f, nodekeys=None) -> float:
    """Log-density at a draw summary (e.g. posterior mean) — the plug-in
    term of DIC (reference modelstats.jl:15-25).  Sites that are not stored
    come from chain 1's final state."""
    cm = mc.compiled
    if nodekeys is None:
        nodekeys = cm.stochastic
    draw_state = _draw_state_fn(mc)
    row = cm.tensor(np.asarray(f(np.asarray(mc.value), axis=(0, 2))))
    base = {k: v[0] for k, v in mc.states["state"].items()}
    return float(cm.logpdf(draw_state(row, base), terms=tuple(nodekeys)))


def dic(mc: ModelChains) -> ChainSummary:
    """Deviance information criterion with pD and pV effective-parameter
    estimates (reference modelstats.jl:3-12)."""
    outputs = mc.model.keys("observed")
    Dhat = -2.0 * logpdf_at(mc, np.mean, outputs)
    D = -2.0 * logpdf_chains(mc, outputs).value.astype(np.float64)
    p = np.array([D.mean() - Dhat, 0.5 * D.var(ddof=1)])
    vals = np.column_stack([Dhat + 2.0 * p, p])
    return ChainSummary(vals, ["pD", "pV"], ["DIC", "Effective Parameters"],
                        _header(mc))


def predict(mc: ModelChains, nodekeys=None, seed: int = 0) -> ModelChains:
    """Posterior-predictive draws of observed output nodes for every stored
    draw (reference modelstats.jl:71-102), from a ``torch.Generator`` on the
    model's device seeded with ``seed`` (no global generator is touched)."""
    cm = mc.compiled
    outputs = mc.model.keys("observed")
    if nodekeys is None:
        nodekeys = outputs
    elif isinstance(nodekeys, str):
        nodekeys = [nodekeys]
    bad = [k for k in nodekeys if k not in outputs]
    if bad:
        raise ValueError(f"nodekeys {bad} are not observed stochastic nodes")
    draw_state = _draw_state_fn(mc)

    from ..utils.pytree import elementwise_names
    labels = []
    for n in nodekeys:
        labels.extend(elementwise_names(n, cm.sites[n].shape))

    rows, bases = _flat_batch(mc)
    states = torch.func.vmap(draw_state)(rows, bases)
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(seed)
    drawn = cm.forward_sample(gen, states, names=nodekeys)
    flat = []
    for n in nodekeys:
        v = drawn[n]                       # (C*n, *shape), column-major out
        flat.append(v.permute(0, *reversed(range(1, v.dim())))
                    .reshape(v.shape[0], -1))
    vals = torch.cat(flat, dim=1).reshape(mc.nchains, mc.niter, -1)
    value = np.moveaxis(vals.detach().cpu().numpy(), 0, 2)   # (n, q, chains)
    return ModelChains(value, start=mc.start, thin=mc.thin, names=labels,
                       chains=mc.chains, model=mc.model, compiled=cm,
                       states=mc.states, iter=mc.iter)
