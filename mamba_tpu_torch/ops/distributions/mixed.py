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
from .base import Distribution


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

    def sample(self, gen, shape=()):
        """Element ``i`` from its own family.  Where the elements' parameters
        carry a batch (chain-stacked ones), it follows ``shape``, and an
        element with a smaller batch draws the missing dims iid."""
        full = self.batch_shape
        cols = []
        for d in self.parts:
            lead = full[: len(full) - len(d.batch_shape)]
            c = d.sample(gen, tuple(shape) + tuple(lead))
            cols.append(c.expand(tuple(shape) + tuple(full)))
        dtype = cols[0].dtype
        for c in cols[1:]:
            dtype = torch.promote_types(dtype, c.dtype)
        return torch.stack([c.to(dtype) for c in cols], dim=-1)

    def bijector(self):
        return Blockwise(tuple(d.bijector() for d in self.parts))
