"""Slice sampling, univariate (coordinate-wise) and multivariate shrinkage
forms, batched over chains (reference src/samplers/slice.jl).

Every chain shrinks its bracket in lockstep: one shrink trip draws a new
candidate for every chain still rejecting, evaluates the batched density
once, and leaves the chains that already accepted as they are.  The host
syncs once per trip (to stop when no chain is still shrinking), never once
per chain.  By default the kernel works on *constrained* values with -inf
support masking, like the reference (Slice(..., transform=false),
slice.jl:50).

Random draws per step, in order (all from ``gen``): univariate — the
bracket offsets ``(C, dim)``, then per coordinate the slice level ``(C,)``,
the first candidate ``(C,)`` and one ``(C,)`` per shrink trip;
multivariate — the slice level ``(C,)``, the bracket offsets ``(C, dim)``,
the first candidate ``(C, dim)`` and one ``(C, dim)`` per shrink trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import SamplerSpec

#: hard cap on shrink trips per chain.  Shrinkage halves the bracket per
#: rejection, so ~60 trips exhaust float64 resolution and a legitimate step
#: needs far fewer; the cap exists for degenerate states (a +inf or ridge
#: density where no candidate can reach the slice level), where the
#: reference's unbounded loop (slice.jl:66-117) would never end.  A chain
#: that reaches the cap rejects the move and keeps its entry value and
#: entry log-density (the log-density is restored, not evaluated again).
MAX_SHRINK = 1000


class SliceTune(NamedTuple):
    width: torch.Tensor     # (dim,) bracket width, shared by every chain


def slice_init(x0, width) -> SliceTune:
    """Tune for chains ``x0 (C, dim)``; ``width`` is a scalar or one width
    per coordinate."""
    return SliceTune(width=torch.as_tensor(width, dtype=x0.dtype, device=x0.device)
                     .expand(x0.shape[1:]).clone())


def _rand(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)


def _with_column(x, i, v):
    x = x.clone()
    x[:, i] = v
    return x


def slice_univariate_step(gen, x, tune: SliceTune, logf):
    """Coordinate-wise shrinkage sweep for chains ``x (C, dim)`` (reference
    slice.jl:66-92); ``logf(x) -> (C,)``."""
    C, n = x.shape
    lower = x - tune.width * _rand(gen, x.shape, x)
    upper = lower + tune.width
    logf0 = logf(x)
    for i in range(n):
        p0 = logf0 + torch.log(_rand(gen, (C,), x))
        xi_old = x[:, i]
        lo, hi = lower[:, i], upper[:, i]
        xi = lo + (hi - lo) * _rand(gen, (C,), x)
        x = _with_column(x, i, xi)
        lf = logf(x)
        active = lf < p0
        trips = torch.zeros(C, dtype=torch.int32, device=x.device)
        for _ in range(MAX_SHRINK):
            if not bool(active.any()):      # the one host sync of a trip
                break
            left = xi < xi_old
            lo = torch.where(active & left, xi, lo)
            hi = torch.where(active & ~left, xi, hi)
            xi = torch.where(active, lo + (hi - lo) * _rand(gen, (C,), x), xi)
            x = _with_column(x, i, xi)
            lf = torch.where(active, logf(x), lf)
            trips = trips + active.to(torch.int32)
            active = active & (lf < p0)
        # a chain at the cap (degenerate slice level) rejects the
        # coordinate move and keeps its entry log-density
        hit = trips >= MAX_SHRINK
        x = _with_column(x, i, torch.where(hit, xi_old, xi))
        logf0 = torch.where(hit, logf0, lf)
    return x, None


def slice_multivariate_step(gen, x, tune: SliceTune, logf):
    """Joint shrinkage step for chains ``x (C, dim)`` (reference
    slice.jl:95-117)."""
    C = x.shape[0]
    p0 = logf(x) + torch.log(_rand(gen, (C,), x))
    lo = x - tune.width * _rand(gen, x.shape, x)
    hi = lo + tune.width
    y = lo + tune.width * _rand(gen, x.shape, x)
    lf = logf(y)
    active = lf < p0
    trips = torch.zeros(C, dtype=torch.int32, device=x.device)
    for _ in range(MAX_SHRINK):
        if not bool(active.any()):          # the one host sync of a trip
            break
        a = active[:, None]
        left = y < x
        lo = torch.where(a & left, y, lo)
        hi = torch.where(a & ~left, y, hi)
        y = torch.where(a, lo + (hi - lo) * _rand(gen, x.shape, x), y)
        lf = torch.where(active, logf(y), lf)
        trips = trips + active.to(torch.int32)
        active = active & (lf < p0)
    # a chain at the cap found no acceptable candidate: reject the move
    return torch.where((trips >= MAX_SHRINK)[:, None], x, y), None


class Slice(SamplerSpec):
    """Slice(params, width, form='multivariate'|'univariate',
    transform=False) — reference slice.jl:47-58."""

    def __init__(self, params, width, form: str = "multivariate",
                 transform: bool = False):
        super().__init__(params)
        if form not in ("univariate", "multivariate"):
            raise ValueError("form must be 'univariate' or 'multivariate'")
        self.width = width
        self.form = form
        self.transform = bool(transform)

    def kernel_init(self, gen, x0, logf):
        return slice_init(x0, self.width)

    def kernel_step(self, gen, x, tune, logf, adapt):
        step = (slice_univariate_step if self.form == "univariate"
                else slice_multivariate_step)
        return step(gen, x, tune, logf)[0], tune
