"""Heterogeneous per-element distribution vectors.

Counterpart of the reference's mixed ``Array{UnivariateDistribution}`` nodes
— one node whose elements follow *different* families (e.g. the magnesium
example's six prior sensitivities, doc/examples/magnesium.jl:74-84; dispatch
machinery in distributionstruct.jl:22-79).

``Mixed(d1, d2, ...)`` behaves as a vector-variate distribution of length
n: log_prob/sample/in_support evaluate each element under its own family
(the families are static, so the loop over them is a Python loop), and the
support bijector is the blockwise stack of the element bijectors.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import bijectors as bij
from .. import random as R
from .base import _KEYS_LEAD, Distribution, keys_lead


@dataclasses.dataclass(frozen=True)
class Blockwise(bij.Bijector):
    """Elementwise-stacked scalar bijectors for a length-n vector."""
    parts: tuple

    def forward(self, u):
        return torch.stack([b.forward(u[..., i])
                            for i, b in enumerate(self.parts)], dim=-1)

    def inverse(self, x):
        return torch.stack([b.inverse(x[..., i])
                            for i, b in enumerate(self.parts)], dim=-1)

    def forward_log_det(self, u):
        return torch.stack([b.forward_log_det(u[..., i])
                            for i, b in enumerate(self.parts)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Mixed(Distribution):
    parts: tuple

    def __init__(self, *dists):
        if len(dists) == 1 and isinstance(dists[0], (tuple, list)):
            dists = tuple(dists[0])
        for d in dists:
            if getattr(d, "event_ndim", 0) != 0:
                raise ValueError("Mixed elements must be univariate")
        object.__setattr__(self, "parts", tuple(dists))

    event_ndim = 1

    @property
    def batch_shape(self):
        # scalar elements: () for one chain's distribution, the chain axis
        # when the elements' parameters are chain-stacked
        return torch.broadcast_shapes(*(d.batch_shape for d in self.parts))

    @property
    def event_shape(self):
        return torch.Size((len(self.parts),))

    def log_prob(self, x):
        return sum(d.log_prob(x[..., i]) for i, d in enumerate(self.parts))

    def in_support(self, x):
        ok = self.parts[0].in_support(x[..., 0])
        for i, d in enumerate(self.parts[1:], start=1):
            ok = ok & d.in_support(x[..., i])
        return ok

    def sample(self, key, shape=()):
        """Element ``i`` from its own family.  Where the elements' parameters
        carry a batch (chain-stacked ones), it follows ``shape``, and an
        element with a smaller batch draws the missing dims iid."""
        full = self.batch_shape
        nk, shape = key.dim() - 1, tuple(shape)
        # keys that lead the parameters lead the draw of an element whose
        # parameters lack their dims
        params = (nk > 0 and _KEYS_LEAD.get() != "draw"
                  and tuple(full[:nk]) == tuple(key.shape[:-1]))
        cols = []
        for d, k in zip(self.parts, R.split(key, len(self.parts))):
            lead = tuple(full[: len(full) - len(d.batch_shape)])
            if params and len(lead) >= nk:
                with keys_lead("draw"):
                    c = d.sample(k, lead[:nk] + shape + lead[nk:]).movedim(
                        tuple(range(nk)), tuple(range(len(shape),
                                                      len(shape) + nk)))
            else:
                c = d.sample(k, shape + lead)
            cols.append(c.expand(shape + tuple(full)))
        dtype = cols[0].dtype
        for c in cols[1:]:
            dtype = torch.promote_types(dtype, c.dtype)
        return torch.stack([c.to(dtype) for c in cols], dim=-1)

    def bijector(self):
        return Blockwise(tuple(d.bijector() for d in self.parts))
