"""Carry numpy trees — inputs, chain-stacked states, sampler tunes and ADVI
fits exported from another implementation of the same model — into this
package's tensors on a given device, so both can be evaluated at, or
continue from, the same state.

A tune exported from a chain-batched implementation has the chain axis
first on every field.  Where this package stores a field once for all
chains (it is shared by construction), the converter checks that every
chain row holds the same value before it keeps one."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..samplers.abc import ABCTune
from ..samplers.amm import AMMTune
from ..samplers.amwg import AMWGTune
from ..samplers.binary import BHMCTune, BIATune, IndexSelect
from ..samplers.chees import ChEESTune
from ..samplers.dgs import DGSTune
from ..samplers.nuts import NUTSTune
from ..samplers.slice import SliceTune
from ..samplers.slicesimplex import SliceSimplexTune


def to_tensor(v, device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy value as a tensor: floating values in ``dtype``, integer and
    boolean values keep their kind."""
    a = np.asarray(v)
    if not a.flags.writeable:      # e.g. a broadcast view: torch wants its own
        a = a.copy()
    return torch.as_tensor(
        a, dtype=dtype if np.issubdtype(a.dtype, np.floating) else None,
        device=device)


def to_tensors(tree: dict, device, dtype: torch.dtype) -> dict:
    """``{name: numpy value}`` -> ``{name: tensor}``."""
    return {k: to_tensor(v, device, dtype) for k, v in tree.items()}


def _fields(tune) -> dict:
    if hasattr(tune, "_asdict"):
        return dict(tune._asdict())
    if dataclasses.is_dataclass(tune):
        return {f.name: getattr(tune, f.name) for f in dataclasses.fields(tune)}
    return dict(tune)


def _shared(name: str, v, ndim: int) -> np.ndarray:
    """One value of a field shared by every chain: ``v`` holds it with a
    leading chain axis when it has more than ``ndim`` dims."""
    a = np.asarray(v)
    if a.ndim == ndim:
        return a
    if a.ndim != ndim + 1:
        raise ValueError(f"tune field {name!r}: expected {ndim} or {ndim + 1} "
                         f"dims, got shape {a.shape}")
    if not np.array_equal(a, np.broadcast_to(a[:1], a.shape), equal_nan=True):
        raise ValueError(f"tune field {name!r} differs across chains; it is "
                         f"shared by every chain")
    return a[0]


def nuts_tune(tune, device, dtype: torch.dtype) -> NUTSTune:
    """A NUTS tune with numpy fields (a NamedTuple or a mapping of the
    same field names; ``adapted`` may be absent) -> ``NUTSTune``.  Without
    an ``adapted`` field, adaptation counts as having run once the averaged
    step has left its initial 1.0, the other implementation's test."""
    fields = _fields(tune)
    if "adapted" not in fields:
        fields["adapted"] = np.asarray(fields["epsilonbar"]) != 1.0
    return NUTSTune(**{k: to_tensor(fields[k], device, dtype)
                       for k in NUTSTune._fields})


def chees_tune(tune, device, dtype: torch.dtype) -> ChEESTune:
    """A ChEES tune, per chain (chain axis first) or already shared ->
    ``ChEESTune``: scalars as 0-d tensors, the mass and window statistics
    as ``(dim,)`` tensors, the counters as ints."""
    fields = _fields(tune)
    out = {}
    for k in ChEESTune._fields:
        if k in ("m", "max_steps", "w_n", "window", "it"):
            out[k] = int(_shared(k, fields[k], 0))
        elif k in ("minv", "w_mean", "w_m2", "w_sw"):
            out[k] = to_tensor(_shared(k, fields[k], 1), device, dtype)
        else:
            out[k] = to_tensor(_shared(k, fields[k], 0), device, dtype)
    return ChEESTune(**out)


def slice_tune(tune, device, dtype: torch.dtype) -> SliceTune:
    """A slice tune (``width`` per chain ``(C, dim)`` or shared ``(dim,)``)
    -> ``SliceTune`` with one shared ``(dim,)`` width."""
    return SliceTune(width=to_tensor(_shared("width", _fields(tune)["width"], 1),
                                     device, dtype))


def amwg_tune(tune, device, dtype: torch.dtype) -> AMWGTune:
    """An AMWG tune with per-chain ``sigma`` and ``accept`` ``(C, dim)`` ->
    ``AMWGTune``; the counter, batch size and target are shared."""
    f = _fields(tune)
    return AMWGTune(
        sigma=to_tensor(f["sigma"], device, dtype),
        accept=torch.as_tensor(np.asarray(f["accept"]), dtype=torch.int32,
                               device=device),
        m=int(_shared("m", f["m"], 0)),
        batchsize=int(_shared("batchsize", f["batchsize"], 0)),
        target=float(_shared("target", f["target"], 0)))


def amm_tune(tune, device, dtype: torch.dtype) -> AMMTune:
    """An AMM tune with per-chain fields (chain axis first: ``SigmaL``,
    ``SigmaLm`` and ``Mvv`` ``(C, dim, dim)``, ``Mv`` ``(C, dim)``, ``m``
    ``(C,)``) -> ``AMMTune``; ``beta`` and ``scale`` are shared."""
    f = _fields(tune)
    return AMMTune(
        **{k: to_tensor(f[k], device, dtype)
           for k in ("SigmaL", "SigmaLm", "Mv", "Mvv")},
        m=torch.as_tensor(np.asarray(f["m"]), dtype=torch.int32, device=device),
        beta=float(_shared("beta", f["beta"], 0)),
        scale=float(_shared("scale", f["scale"], 0)))


def slicesimplex_tune(tune, device, dtype: torch.dtype) -> SliceSimplexTune:
    """A SliceSimplex tune (``scale`` per chain or shared) ->
    ``SliceSimplexTune`` with one shared scale."""
    return SliceSimplexTune(scale=to_tensor(
        _shared("scale", _fields(tune)["scale"], 0), device, dtype))


def dgs_tune(tune, device, dtype: torch.dtype) -> DGSTune:
    """A DGS tune (the support grid and its mask, ``(n, K)`` each, per chain
    or shared) -> ``DGSTune``."""
    f = _fields(tune)
    return DGSTune(support=to_tensor(_shared("support", f["support"], 2),
                                     device, dtype),
                   mask=torch.as_tensor(_shared("mask", f["mask"], 2),
                                        dtype=torch.bool, device=device))


def bhmc_tune(tune, device, dtype: torch.dtype) -> BHMCTune:
    """A BHMC tune with per-chain ``position``, ``velocity`` ``(C, n)`` and
    counters ``(C,)`` -> ``BHMCTune``; ``traveltime`` is shared."""
    f = _fields(tune)
    counts = {k: torch.as_tensor(np.asarray(f[k]), dtype=torch.int32,
                                 device=device)
              for k in ("wallhits", "wallcrosses")}
    return BHMCTune(traveltime=float(_shared("traveltime", f["traveltime"], 0)),
                    position=to_tensor(f["position"], device, dtype),
                    velocity=to_tensor(f["velocity"], device, dtype), **counts)


def bia_tune(tune, device, dtype: torch.dtype) -> BIATune:
    """A BIA tune with per-chain ``A``, ``D`` ``(C, n)`` -> ``BIATune``;
    ``epsilon``, ``decay``, ``target`` and the counter are shared."""
    f = _fields(tune)
    return BIATune(A=to_tensor(f["A"], device, dtype),
                   D=to_tensor(f["D"], device, dtype),
                   **{k: float(_shared(k, f[k], 0))
                      for k in ("epsilon", "decay", "target")},
                   iter=int(_shared("iter", f["iter"], 0)))


def index_tune(tune, device, dtype: torch.dtype) -> IndexSelect:
    """A BMC3 or BMG tune (``k``, or the group masks ``(G, n)``) ->
    ``IndexSelect``."""
    f = _fields(tune)
    g = f["groups_mask"]
    return IndexSelect(
        groups_mask=None if g is None else torch.as_tensor(
            _shared("groups_mask", g, 2), dtype=torch.bool, device=device),
        k=int(_shared("k", f["k"], 0)))


def abc_tune(tune, device, dtype: torch.dtype) -> ABCTune:
    """An ABC tune, per chain (``Tsim (C, nsim, Tdim)``, tolerances
    ``(C, nsim)``) -> ``ABCTune``."""
    return ABCTune(**{k: to_tensor(v, device, dtype)
                      for k, v in _fields(tune).items()})


def tune_to_numpy(tune) -> dict:
    """The way back: a tune of this package (a NamedTuple of tensors, ints,
    floats and None) as ``{field: numpy value}``, to build the other
    implementation's tune from."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else None if v is None else np.asarray(v))
            for k, v in _fields(tune).items()}


def advi_result(mu, log_sigma, model, inputs: dict, inits: dict, params=None,
                *, device, dtype=None):
    """An ADVI fit ``(mu, log_sigma)`` (the block's unconstrained ravel
    order, which sorts sites by name in both packages) -> this package's
    ``ADVIResult`` for ``model``, to sample from or warm-start with."""
    from ..infer.advi import ADVIResult, _setup
    cm, params, _, unpack, spec, _, state0 = _setup(
        model, inputs, inits, params, device=device, dtype=dtype)
    return ADVIResult(mu=cm.tensor(np.asarray(mu)),
                      log_sigma=cm.tensor(np.asarray(log_sigma)),
                      elbo_trace=np.zeros(0), params=params, _cm=cm,
                      _unpack=unpack, _spec=spec, _state0=state0)


#: the converter of each sampler block's tune, by the block's class name
_TUNE_CONVERTERS = {
    "NUTS": nuts_tune, "ChEESHMC": chees_tune, "Slice": slice_tune,
    "AMWG": amwg_tune, "AMM": amm_tune, "SliceSimplex": slicesimplex_tune,
    "BHMC": bhmc_tune, "BIA": bia_tune, "BMC3": index_tune, "BMG": index_tune,
    "ABC": abc_tune,
}


def block_tune(spec, tune, device, dtype: torch.dtype):
    """One sampler block's tune with numpy fields -> this package's tune for
    the block ``spec``: a DGS block holds one tune per node (a sequence),
    a Gibbs or MISS block none."""
    kind = type(spec).__name__
    if kind in ("Gibbs", "MISS"):
        return ()
    if kind == "DGS":
        return tuple(dgs_tune(t, device, dtype) for t in tune)
    if kind not in _TUNE_CONVERTERS:
        raise ValueError(f"no tune converter for a {kind} block")
    return _TUNE_CONVERTERS[kind](tune, device, dtype)


def model_chains(value, model, inputs: dict, state: dict, tunes=None, *,
                 start: int = 1, thin: int = 1, names=None, chains=None,
                 iter=None, burnin: int = 0, seed: int = 0, key=None,
                 device, dtype=None):
    """Another implementation's run of ``model`` — its kept draws ``value``
    ``(iterations, params, chains)``, its final chain-stacked ``state``
    ``{site: (chains, ...)}`` and, optionally, its blocks' ``tunes`` (one
    per sampler block, numpy fields, as the block converters take them) —
    as this package's ``ModelChains`` on ``device``, to compute model-based
    statistics over the same draws or to continue the run.  Without
    ``tunes`` each block's tune is its ``init`` at ``state``.  ``key`` is
    the run's per-chain key data ``(chains, 2)`` uint32 (the JAX package's
    ``jax.random.key_data(states["key"])``), which a restart goes on from;
    without it chain ``i`` takes ``fold_in(key(seed), i)``."""
    from ..model.compile import compile_model
    from ..output.chains import ModelChains
    cm = compile_model(model, inputs, {k: np.asarray(v)[0] for k, v in state.items()},
                       device=device, dtype=dtype)
    st = {k: cm.tensor(np.asarray(v)) for k, v in state.items()}
    from ..ops import random as R
    chains_n = list(st.values())[0].shape[0]   # (``iter`` is an argument)
    keys = (R.chain_keys(seed, range(chains_n), cm.device) if key is None
            else torch.as_tensor(np.asarray(key, dtype=np.int64),
                                 device=cm.device))
    if tunes is None:
        tunes = tuple(s.build(cm).init(keys, st) for s in model.samplers)
    else:
        tunes = tuple(block_tune(s, t, cm.device, cm.dtype)
                      for s, t in zip(model.samplers, tunes, strict=True))
    value = np.asarray(value)
    return ModelChains(
        value, start=start, thin=thin, names=names, chains=chains,
        model=model, compiled=cm,
        states={"key": keys, "state": st, "tunes": tunes,
                "burnin": burnin},
        iter=iter)
