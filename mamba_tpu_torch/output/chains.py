"""Chains: the 3-D posterior-sample container.

Counterpart of reference src/output/chains.jl / modelchains.jl.
``value`` is ``(iterations, params, chains)`` exactly like the reference's
``Chains.value`` (chains.jl:5-17).  Samples arrive as one device array from
the engine (fetched once at the end of a run); summaries/diagnostics
consume it as numpy.

Indexing follows the reference's thinning-aware semantics (chains.jl:61-104):
``c[iters, pars, chains]`` where ``iters`` are *absolute* iteration numbers
aligned to ``c.range``; parameter selection by name, list of names, or
slice; model-node selection (``mc[:, "beta", :]`` expanding to
``beta[1], beta[2]``) on ModelChains (modelchains.jl:31-57).
"""

from __future__ import annotations

import numpy as np


class Chains:
    def __init__(self, value, start: int = 1, thin: int = 1, names=None,
                 chains=None):
        value = np.asarray(value)
        if value.ndim == 2:
            value = value[:, :, None]
        if value.ndim != 3:
            raise ValueError("Chains value must be (iterations, params, chains)")
        n, p, m = value.shape
        self.value = value
        self.start = int(start)
        self.thin = int(thin)
        self.names = list(names) if names is not None else [f"Param{i+1}" for i in range(p)]
        if len(self.names) != p:
            raise ValueError("names length mismatch")
        self.chains = list(chains) if chains is not None else list(range(1, m + 1))
        if len(self.chains) != m:
            raise ValueError("chains length mismatch")

    # -- reference-style accessors --------------------------------------
    @property
    def range(self) -> np.ndarray:
        """Absolute iteration numbers of the stored rows (chains.jl range)."""
        n = self.value.shape[0]
        return self.start + self.thin * np.arange(n)

    @property
    def niter(self):
        return self.value.shape[0]

    @property
    def nparams(self):
        return self.value.shape[1]

    @property
    def nchains(self):
        return self.value.shape[2]

    def last(self) -> int:
        return int(self.range[-1]) if self.niter else self.start - self.thin

    # -- indexing --------------------------------------------------------
    def _param_indices(self, pars):
        if pars is None or (isinstance(pars, slice) and pars == slice(None)):
            return list(range(self.nparams))
        if isinstance(pars, str):
            pars = [pars]
        if isinstance(pars, slice):
            return list(range(*pars.indices(self.nparams)))
        out = []
        for p in pars:
            if isinstance(p, str):
                if p in self.names:
                    out.append(self.names.index(p))
                else:
                    # node-name expansion: "beta" -> beta[1], beta[2], ...
                    sub = [i for i, n in enumerate(self.names)
                           if n == p or n.startswith(p + "[")]
                    if not sub:
                        raise KeyError(f"unknown parameter {p!r}")
                    out.extend(sub)
            else:
                out.append(int(p))
        return out

    def _iter_indices(self, iters):
        if iters is None or (isinstance(iters, slice) and iters == slice(None)):
            return np.arange(self.niter)
        rng = self.range
        if isinstance(iters, slice):
            lo = iters.start if iters.start is not None else rng[0]
            hi = iters.stop if iters.stop is not None else rng[-1] + 1
            mask = (rng >= lo) & (rng < hi)
            return np.nonzero(mask)[0]
        iters = np.atleast_1d(iters)
        idx = np.searchsorted(rng, iters)
        if not np.all((idx < len(rng)) & (rng[np.clip(idx, 0, len(rng)-1)] == iters)):
            raise IndexError("iteration numbers not aligned to chain range")
        return idx

    def _chain_indices(self, chains):
        if chains is None or (isinstance(chains, slice) and chains == slice(None)):
            return list(range(self.nchains))
        if isinstance(chains, slice):
            return list(range(*chains.indices(self.nchains)))
        return [int(c) for c in np.atleast_1d(chains)]

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = key + (slice(None),) * (3 - len(key))
        iters, pars, chs = key
        ii = self._iter_indices(iters)
        pi = self._param_indices(pars)
        ci = self._chain_indices(chs)
        val = self.value[np.ix_(ii, pi, ci)]
        start = int(self.range[ii[0]]) if len(ii) else self.start
        thin = int(self.range[ii[1]] - self.range[ii[0]]) if len(ii) > 1 else self.thin
        return self._like(val, start=start, thin=thin,
                          names=[self.names[i] for i in pi],
                          chains=[self.chains[i] for i in ci])

    def _like(self, value, start, thin, names, chains):
        return Chains(value, start=start, thin=thin, names=names, chains=chains)

    # -- concatenation (reference chains.jl:106-156) ---------------------
    def cat_iters(self, other: "Chains") -> "Chains":
        if self.names != other.names or self.chains != other.chains:
            raise ValueError("names/chains must match to concatenate iterations")
        if self.thin != other.thin:
            raise ValueError("thinning intervals differ")
        if other.start != self.last() + self.thin:
            raise ValueError(
                f"noncontiguous chains: next start {other.start} != "
                f"{self.last() + self.thin}")
        return self._like(np.concatenate([self.value, other.value], 0),
                          start=self.start, thin=self.thin,
                          names=self.names, chains=self.chains)

    def cat_params(self, other: "Chains") -> "Chains":
        if (self.start, self.thin, self.niter) != (other.start, other.thin, other.niter):
            raise ValueError("iteration ranges must match")
        if self.chains != other.chains:
            raise ValueError("chains must match")
        dup = set(self.names) & set(other.names)
        if dup:
            raise ValueError(f"duplicate parameter names {sorted(dup)}")
        return self._like(np.concatenate([self.value, other.value], 1),
                          start=self.start, thin=self.thin,
                          names=self.names + other.names, chains=self.chains)

    def cat_chains(self, other: "Chains") -> "Chains":
        if (self.start, self.thin, self.niter) != (other.start, other.thin, other.niter):
            raise ValueError("iteration ranges must match")
        if self.names != other.names:
            raise ValueError("parameter names must match")
        return self._like(np.concatenate([self.value, other.value], 2),
                          start=self.start, thin=self.thin, names=self.names,
                          chains=self.chains + [c + max(self.chains) for c in
                                                range(1, other.nchains + 1)])

    def cat(self, dim: int, *others: "Chains") -> "Chains":
        """Variadic concatenation (reference ``cat(dim, c1, c2, ...)``,
        chains.jl:106-156): dim 1 = iterations (contiguity-checked),
        2 = params (duplicate-name-checked), 3 = chains (ids relabeled).
        Folds pairwise, so every pairwise validation applies."""
        fold = {1: Chains.cat_iters, 2: Chains.cat_params,
                3: Chains.cat_chains}.get(dim)
        if fold is None:
            raise ValueError(f"cat dim must be 1, 2 or 3, got {dim}")
        out = self
        for o in others:
            out = fold(out, o)
        return out

    def link(self) -> np.ndarray:
        """Heuristic unconstraining transform of the stored draws
        (reference chains.jl:237-246): positive columns -> log,
        unit-interval columns -> logit, others untouched.  ModelChains
        overrides this with each node's actual transform."""
        from .diagnostics import link_values
        return link_values(self)

    def combine(self) -> np.ndarray:
        """Stack all chains into one (niter*nchains, nparams) matrix
        (reference chains.jl:190-201)."""
        n, p, m = self.value.shape
        return np.transpose(self.value, (0, 2, 1)).reshape(n * m, p)

    def __repr__(self):
        return (f"{type(self).__name__}(iterations={self.start}:"
                f"{self.last()}:{self.thin}, params={len(self.names)}, "
                f"chains={len(self.chains)})")


class ModelChains(Chains):
    """Chains + the model/compiled-model/per-chain final states that produced
    them (reference modelchains.jl:5-16 plus the ModelState snapshots the
    reference keeps on Model, src/Mamba.jl:152-165).  Enables restart
    ``mcmc(mc, iters)`` and model-based stats (dic/predict/logpdf)."""

    def __init__(self, value, start=1, thin=1, names=None, chains=None,
                 model=None, compiled=None, states=None, iter=None,
                 timing=None):
        super().__init__(value, start=start, thin=thin, names=names, chains=chains)
        self.model = model
        self.compiled = compiled
        #: per-chain resume state: dict(rng=..., state=..., tunes=...)
        self.states = states
        self.iter = iter if iter is not None else self.last()
        #: wall-clock breakdown of the run that produced these draws:
        #: sample_s (device compute, synchronized), fetch_s
        #: (device->host transfer of the kept draws), setup_s
        self.timing = timing

    def _like(self, value, start, thin, names, chains):
        return ModelChains(value, start=start, thin=thin, names=names,
                           chains=chains, model=self.model,
                           compiled=self.compiled, states=self.states,
                           iter=self.iter)

    def keys(self, ntype: str = "monitor") -> list:
        """Node-name query filtered to nodes actually present in storage
        (reference ``keys(mc, ntype)``, modelchains.jl:40-50): the Model
        answers what *could* be monitored; this answers what *is* in the
        stored columns."""
        stored = {lbl.split("[")[0] for lbl in self.names}
        return [n for n in self.model.keys(ntype) if n in stored]

    def link(self) -> np.ndarray:
        """Model-aware unconstraining transform of the stored draws
        (reference modelchains.jl:55-73): each fully-stored stochastic
        site's own bijector maps its columns to unconstrained space (where
        the transform is elementwise); discrete sites get identity; only
        leftover columns (logical nodes, partially-monitored sites,
        shape-changing transforms like simplex/Cholesky) fall back to the
        ``Chains.link`` positive/unit heuristic.  The bijectors run in
        float64 on the model's device."""
        if self.compiled is None:
            return super().link()
        import torch

        from .modelstats import _site_columns, _unpack_site

        cm = self.compiled
        cc = np.array(self.value, dtype=float, copy=True)
        handled = np.zeros(cc.shape[1], dtype=bool)
        try:
            cols = _site_columns(self)
        except ValueError:
            cols = {}
        for n, (off, shape) in cols.items():
            if n not in cm.sites:
                continue          # logical node -> heuristic fallback
            size = int(np.prod(shape)) if shape else 1
            span = slice(off, off + size)
            if getattr(cm.example_dists[n], "is_discrete", False):
                handled[span] = True       # identity (reference link_sub)
                continue
            bij = cm.example_dists[n].bijector()
            if tuple(bij.unconstrained_shape(shape)) != tuple(shape):
                continue          # shape-changing transform: not columnwise
            # (niter, size, nchains) -> (niter, nchains, *shape), inverse
            # elementwise (bounds broadcast in site shape), re-flatten
            # column-major
            block = torch.as_tensor(np.moveaxis(cc[:, span, :], 2, 1),
                                    dtype=torch.float64, device=cm.device)
            u = bij.inverse(_unpack_site(block, shape))
            flat = (u.permute(0, 1, *reversed(range(2, u.dim())))
                    .reshape(u.shape[0], u.shape[1], -1) if shape
                    else u[..., None])
            cc[:, span, :] = np.moveaxis(
                flat.to(torch.float64).cpu().numpy(), 1, 2)
            handled[span] = True
        # heuristic for whatever the model could not claim
        for j in np.nonzero(~handled)[0]:
            x = cc[:, j, :]
            if x.min() > 0.0:
                cc[:, j, :] = (np.log(x / (1.0 - x)) if x.max() < 1.0
                               else np.log(x))
        return cc
