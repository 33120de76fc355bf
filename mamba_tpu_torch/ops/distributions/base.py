"""Distribution protocol: batched distributions over torch tensors.

Counterpart of the reference's Distributions.jl dependency plus its
DistributionStruct dispatch layer (reference: src/Mamba.jl:67-69,
src/distributions/distributionstruct.jl:14-186).  Where the reference holds
``Array{UnivariateDistribution}`` — one Julia object per observation, looped
over serially — here a single distribution object carries *batched*
parameter tensors and ``log_prob`` evaluates every element in one pass.

Conventions
-----------
- Every distribution is a frozen dataclass whose parameter fields are
  (broadcastable) tensors or Python numbers.  Distributions are built inside
  the compiled model's functions, under ``torch.func.vmap`` over chains.
- ``event_ndim``: 0 univariate, 1 vector-variate, 2 matrix-variate.
- ``log_prob(x)`` reduces over the event dims only and returns batch-shaped
  values; node-level densities sum the batch.
- ``sample(key, shape)`` prepends ``shape`` to the broadcasted batch shape,
  drawing from ``key`` (``ops/random.py``): one key, or a batch of keys
  ``(*K, 2)`` that leads the parameters (one per chain of chain-stacked
  parameters) or the draw, each drawing its own rows.
- ``bijector()`` returns the support transform used for unconstrained
  sampling (reference link/invlink, transformdistribution.jl).
- ``in_support(x)`` is the vectorized ``insupport`` check used to mask
  impossible states to -inf (reference: distributionstruct.jl:138-140).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from .. import bijectors as bij
from .. import random as R


def distribution(cls):
    """Class decorator: frozen dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


def _shape(a):
    return a.shape if isinstance(a, torch.Tensor) else torch.Size()


class Distribution:
    event_ndim: int = 0
    is_discrete: bool = False

    # ---- shapes -------------------------------------------------------
    @property
    def param_shapes(self):
        return tuple(_shape(getattr(self, f.name))
                     for f in dataclasses.fields(self))

    @property
    def batch_shape(self):
        shapes = self.param_shapes
        if not shapes:
            return torch.Size()
        full = torch.broadcast_shapes(*shapes)
        if self.event_ndim == 0:
            return full
        return full[: len(full) - self.event_ndim]

    @property
    def event_shape(self):
        if self.event_ndim == 0:
            return torch.Size()
        full = torch.broadcast_shapes(*self.param_shapes)
        return full[len(full) - self.event_ndim:]

    # ---- interface ----------------------------------------------------
    def log_prob(self, x) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, key, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def bijector(self) -> bij.Bijector:
        return bij.Identity()

    def in_support(self, x) -> torch.Tensor:
        """Boolean mask, batch-shaped (event dims reduced with AND)."""
        shape = torch.broadcast_shapes(x.shape, self.batch_shape + self.event_shape)
        if self.event_ndim:
            shape = shape[: len(shape) - self.event_ndim]
        return torch.ones(shape, dtype=torch.bool, device=x.device)

    # total log density of a value under this (possibly batched) distribution
    def total_log_prob(self, x) -> torch.Tensor:
        lp = self.log_prob(x)
        ok = self.in_support(x)
        lp = torch.where(ok, lp, -torch.inf)
        return torch.sum(lp)

    # ---- optional moments (used by user Gibbs blocks) ----------------
    def mean(self):
        raise NotImplementedError(f"mean not defined for {type(self).__name__}")

    def variance(self):
        raise NotImplementedError(f"variance not defined for {type(self).__name__}")


class UnivariateDistribution(Distribution):
    event_ndim = 0

    def in_support(self, x):
        return torch.ones(torch.broadcast_shapes(x.shape, self.batch_shape),
                          dtype=torch.bool, device=x.device)


class DiscreteUnivariateDistribution(UnivariateDistribution):
    is_discrete = True

    def bijector(self):
        return bij.Discrete()

    def support_bounds(self):
        """(lo, hi) integer bounds of the support, for DGS enumeration
        (reference: src/samplers/dgs.jl:109-126).  ``hi`` may be a tensor."""
        raise NotImplementedError


def _support(dist, x, cond):
    """``cond`` (a mask computed from ``x`` alone) at the full batch shape."""
    return cond.expand(torch.broadcast_shapes(x.shape, dist.batch_shape))


def _is_int(x):
    """Whole-number test for discrete values held in a float state."""
    return torch.abs(x - torch.round(x)) < 1e-8


# ---- random draws: every one takes a batch of keys ------------------------
def _on(key, *params):
    """``_bc`` of the parameters, on the keys' device."""
    return tuple(t.to(key.device) for t in _bc(*params))


def _cast_on(key, *params):
    """``_cast`` of the parameters, on the keys' device."""
    return tuple(t.to(key.device) for t in _cast(*params))


#: where a batch of keys sits in the draws made under ``keys_lead``
_KEYS_LEAD = contextvars.ContextVar("keys_lead", default=None)


@contextlib.contextmanager
def keys_lead(where: str):
    """Say where a batch of keys ``(*K, 2)`` sits in the draws made inside:
    ``"params"``, at the parameters' leading dims (chain-stacked
    parameters; the K dims follow ``shape``), or ``"draw"``, at the draw's
    leading dims (``shape`` starts with K; parameters shared by every
    key).  Outside it the shapes decide, the parameters first; a caller
    that draws for chains says which, so that a batch that happens to have
    the chain count never takes the other place."""
    if where not in ("params", "draw"):
        raise ValueError(f"keys lead the 'params' or the 'draw' (got {where!r})")
    token = _KEYS_LEAD.set(where)
    try:
        yield
    finally:
        _KEYS_LEAD.reset(token)


def _layout(key, shape, like_shape):
    """Where a batch of keys ``(*K, 2)`` sits in a draw of ``shape +
    like_shape``: at the parameters' leading dims (the K dims follow
    ``shape``), or at the draw's leading dims, as ``keys_lead`` says (else
    the parameters' where they fit).  Returns the per-key shape and the
    maps ``front`` (the K dims of a full-shaped tensor first) and ``back``
    (K-led to full-shaped)."""
    nk = key.dim() - 1
    K = tuple(key.shape[:-1])
    full = tuple(shape) + tuple(like_shape)
    if nk == 0:
        return full, (lambda t: t), (lambda t: t)
    where = _KEYS_LEAD.get()
    fits = {"params": tuple(like_shape[:nk]) == K, "draw": full[:nk] == K}
    if where is None:
        where = "params" if fits["params"] else "draw"
    if not fits[where]:
        raise ValueError(f"keys of batch {K} do not lead the {where} "
                         f"(draw {full}, parameters {tuple(like_shape)})")
    p = len(tuple(shape)) if where == "params" else 0
    lead, at = tuple(range(nk)), tuple(range(p, p + nk))
    return (full[:p] + full[p + nk:], (lambda t: t.movedim(at, lead)),
            (lambda t: t.movedim(lead, at)))


def _rand(key, shape, like, minval=0.0):
    """Uniform [minval, 1) draws of shape ``shape + like.shape``."""
    per, _, back = _layout(key, shape, like.shape)
    return back(R.uniform(key, per, like.dtype, minval, 1.0))


def _normal(key, shape, like_shape, dtype):
    """Standard normals of shape ``shape + like_shape``."""
    per, _, back = _layout(key, shape, like_shape)
    return back(R.normal(key, per, dtype))


def _randn(key, shape, like):
    return _normal(key, shape, like.shape, like.dtype)


def _rexp(key, shape, like):
    """Standard exponential draws, strictly positive."""
    return -torch.log1p(-_rand(key, shape, like))


def _rgamma(key, shape, a):
    """Gamma(a, 1) draws of shape ``shape + a.shape`` (``gamma_bounded``).
    A draw that underflows (a tiny ``a``: InverseGamma(0.001, 0.001)) is
    the smallest normal number, as torch's own sampler gives it, so that
    ``1 / g`` stays finite."""
    return _rgamma_at(key, shape, a.expand(tuple(shape) + tuple(a.shape)))


def _rgamma_at(key, shape, a):
    """``_rgamma`` where ``a`` already has the draw's shape, ``shape``
    followed by the parameters' batch."""
    _, front, back = _layout(key, shape, a.shape[len(tuple(shape)):])
    g = back(R.gamma_bounded(key, front(a)))
    return torch.clamp(g, min=torch.finfo(g.dtype).tiny)


def _rpoisson(key, shape, lam):
    _, front, back = _layout(key, shape, lam.shape)
    return back(R.poisson(key, front(lam.expand(tuple(shape) + tuple(lam.shape)))))


def _rbinomial(key, shape, n, p):
    """Binomial(n, p) draws of shape ``shape + p.shape``."""
    _, front, back = _layout(key, shape, p.shape)
    full = tuple(shape) + tuple(p.shape)
    return back(R.binomial(key, front(n.expand(full)), front(p.expand(full))))


def _rcategorical(key, shape, logits):
    """One index per row of ``logits (..., K)`` (unnormalized log weights),
    of shape ``shape + logits.shape[:-1]``: ``argmax(logits + gumbel)``
    (``jax.random.categorical``)."""
    _, front, back = _layout(key, shape, logits.shape[:-1])
    full = logits.expand(tuple(shape) + tuple(logits.shape))
    return back(R.categorical(key, front(full)))


# ---- distributions as trees of tensors ------------------------------------
def dist_flatten(d):
    """``(leaves, rebuild)``: the tensor parameters of a distribution, of a
    distribution nested in it (``Truncated.base``) or of a tuple of them
    (``Mixed.parts``), and a function that builds the same distribution from
    new leaves.  It lets a distribution cross ``torch.func.vmap``, which
    returns tensors only: the leaves come back chain-stacked and the rebuilt
    distribution is drawn from once, outside ``vmap``."""
    leaves = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            return ("leaf", len(leaves) - 1)
        if isinstance(v, Distribution) and dataclasses.is_dataclass(v):
            return ("dist", type(v), [(f.name, walk(getattr(v, f.name)))
                                      for f in dataclasses.fields(v)])
        if isinstance(v, tuple) and any(isinstance(e, Distribution) for e in v):
            return ("tuple", [walk(e) for e in v])
        return ("static", v)

    plan = walk(d)

    def build(node, new):
        kind = node[0]
        if kind == "leaf":
            return new[node[1]]
        if kind == "static":
            return node[1]
        if kind == "tuple":
            return tuple(build(e, new) for e in node[1])
        obj = object.__new__(node[1])
        for name, sub in node[2]:
            object.__setattr__(obj, name, build(sub, new))
        return obj

    return leaves, lambda new: build(plan, list(new))


def param_like(d, device=None):
    """A 0-d tensor with the floating dtype that the distribution's tensor
    parameters promote to (the default dtype when it has none): the ``like``
    of a ``_bc`` call that has no value to take its dtype from."""
    dtype = torch.get_default_dtype()
    dev = device
    for t in dist_flatten(d)[0]:
        if t.is_floating_point():
            dtype = torch.promote_types(dtype, t.dtype)
        if dev is None:
            dev = t.device
    return torch.zeros((), dtype=dtype, device=dev)


def _bc(*params, like=None):
    """Broadcast scalar-ish params to a common shape as float tensors.

    With ``like`` (the value a density is evaluated at) every parameter is
    promoted to its dtype and device, so a model lambda's ``torch.zeros(G)``
    (default dtype) meets a float64 state on the CPU without losing
    precision; Python numbers are converted straight to that dtype."""
    return tuple(torch.broadcast_tensors(*_cast(*params, like=like)))


def _cast(*params, like=None):
    """``_bc`` without the broadcast: each parameter keeps its own shape (the
    vector and matrix parameters of a multivariate distribution)."""
    tensors = [p for p in params if isinstance(p, torch.Tensor)]
    if like is not None and like.is_floating_point():
        dtype, device = like.dtype, like.device
    else:
        dtype = torch.get_default_dtype()
        for t in tensors:
            if t.is_floating_point():
                dtype = torch.promote_types(dtype, t.dtype)
        device = tensors[0].device if tensors else None
    # a parameter that already has the dtype and device is taken as it is:
    # ``to`` would return it too, after a dispatch that costs host time.  A
    # Python number becomes a tensor by a fill on the device, not by a copy
    # from the host, which would wait for the device (and cannot be captured
    # in a CUDA graph)
    return tuple((p if p.dtype == dtype and (device is None or p.device == device)
                  else p.to(dtype=dtype, device=device))
                 if isinstance(p, torch.Tensor)
                 else torch.full((), p, dtype=dtype, device=device)
                 if isinstance(p, (int, float))
                 else torch.as_tensor(p, dtype=dtype, device=device)
                 for p in params)
