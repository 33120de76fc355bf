"""Slice sampling, univariate (coordinate-wise) and multivariate shrinkage
forms, batched over chains (reference src/samplers/slice.jl).

Every chain shrinks its bracket in lockstep: one shrink trip draws a new
candidate for every chain still rejecting, evaluates the batched density
once, and leaves the chains that already accepted as they are.  Trips run
in batches of ``TRIPS``: the host tests once per batch (``graphs.until_done``)
whether any chain is still shrinking, never once per chain, and the trips
of a batch after every chain has accepted change nothing.  Run eagerly, a
batch also tests before each trip and ends at the first of those
(``graphs.idle``).  By
default the kernel works on *constrained* values with -inf support
masking, like the reference (Slice(..., transform=false), slice.jl:50).

The step is a few bodies on tensors of their own (``utils.graphs.Captured``):
the first batch of a coordinate (or of the multivariate step) together with
its set-up (slice level, first candidate, first density call), and a batch
of trips after it.  In the engine they are replayed from CUDA graphs, the
coordinate index living on the device so that one graph serves every
coordinate; the stand-alone steps run the same bodies eagerly.

Random draws per step, all uniform, from the block's per-chain keys
``(C, 2)`` folded with a number that names the draw: univariate — the
bracket offsets ``(C, dim)`` (fold 0), then every coordinate's first batch
``(dim, TRIPS + 2, C)`` (fold 1; row 0 the slice level, row 1 the first
candidate, then one row per trip), then coordinate ``i``'s further batch
``j`` ``(TRIPS, C)`` (fold ``2 + i * _batches() + j``); multivariate — the
slice level ``(C,)`` (fold 0), the first batch ``(TRIPS + 2, C, dim)``
(fold 1; the bracket offsets, the first candidate, one row per trip), then
further batch ``j`` ``(TRIPS, C, dim)`` (fold ``1 + j``).  Each chain's
numbers come from its own key (``ops/random.py``), whatever batches the
other chains need.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import random as R
from ..utils import graphs
from .base import SamplerSpec, captured, plain

#: hard cap on shrink trips per chain.  Shrinkage halves the bracket per
#: rejection, so ~60 trips exhaust float64 resolution and a legitimate step
#: needs far fewer; the cap exists for degenerate states (a +inf or ridge
#: density where no candidate can reach the slice level), where the
#: reference's unbounded loop (slice.jl:66-117) would never end.  A chain
#: that reaches the cap rejects the move and keeps its entry value and
#: entry log-density (the log-density is restored, not evaluated again).
MAX_SHRINK = 1000

#: shrink trips per batch of a captured step, between two host tests.  On
#: the card the device is busy most of a captured step, so a trip that no
#: chain needs costs more than the host test a longer batch saves: of the
#: lengths 8, 12, 16 and 24, 8 gave the shortest wall on every zoo model
#: measured, though the deepest of 1024 chains often needs a second batch
#: (PERF.md §6, ``scripts/trips_sweep.py``)
TRIPS = 8


class SliceTune(NamedTuple):
    width: torch.Tensor     # (dim,) bracket width, shared by every chain


def slice_init(x0, width) -> SliceTune:
    """Tune for chains ``x0 (C, dim)``; ``width`` is a scalar or one width
    per coordinate."""
    return SliceTune(width=torch.as_tensor(width, dtype=x0.dtype, device=x0.device)
                     .expand(x0.shape[1:]).clone())


def _batches():
    """Bodies a coordinate (or step) runs at most: enough batches to reach
    ``MAX_SHRINK`` trips, where every chain has stopped."""
    return math.ceil(MAX_SHRINK / TRIPS)


# ---------------------------------------------------------------------------
# univariate
# ---------------------------------------------------------------------------

def _uni_trip(b, logf, u):
    """One shrink trip of coordinate ``b["col"]`` for every chain still
    shrinking, on the uniforms ``u (C,)``.  A chain that reaches
    ``MAX_SHRINK`` trips takes its entry value and log-density back and
    stops."""
    active, xi, xi_old, col = b["active"], b["xi"], b["xi_old"], b["col"]
    left = xi < xi_old
    lo = torch.where(active & left, xi, b["lo"])
    hi = torch.where(active & ~left, xi, b["hi"])
    xi2 = torch.where(active, lo + (hi - lo) * u, xi)
    lf = torch.where(active, logf(torch.where(col, xi2[:, None], b["x"])), b["lf"])
    trips = b["trips"] + active.to(torch.int32)
    hit = trips >= MAX_SHRINK
    xi2 = torch.where(hit, xi_old, xi2)
    b["lf"].copy_(torch.where(hit, b["logf0"], lf))
    b["active"].copy_(active & (lf < b["p0"]) & ~hit)
    b["lo"].copy_(lo)
    b["hi"].copy_(hi)
    b["xi"].copy_(xi2)
    b["trips"].copy_(trips)
    b["x"].copy_(torch.where(col, xi2[:, None], b["x"]))


def _uni_batch(b, logf, us):
    for k in range(us.shape[0]):
        if graphs.idle(b["active"]):
            break
        _uni_trip(b, logf, us[k])
    b["more"].copy_(b["active"].any())


def _uni_coordinate(b, logf):
    """Set-up of coordinate ``b["i"]`` (its slice level, first candidate
    and density there) and its first batch of trips."""
    i, x = b["i"], b["x"]
    u = b["u"].index_select(0, i)[0]            # (TRIPS + 2, C)
    col = b["cols"] == i
    xi_old = x.index_select(1, i)[:, 0]
    lo = b["lower"].index_select(1, i)[:, 0]
    hi = b["upper"].index_select(1, i)[:, 0]
    p0 = b["logf0"] + torch.log(u[0])
    xi = lo + (hi - lo) * u[1]
    x2 = torch.where(col, xi[:, None], x)
    lf = logf(x2)
    b["col"].copy_(col)
    b["xi_old"].copy_(xi_old)
    b["lo"].copy_(lo)
    b["hi"].copy_(hi)
    b["p0"].copy_(p0)
    b["xi"].copy_(xi)
    b["lf"].copy_(lf)
    b["active"].copy_(lf < p0)
    b["trips"].zero_()
    x.copy_(x2)
    _uni_batch(b, logf, u[2:])


def _uni_start(b, logf):
    """The step's set-up (brackets, entry log-density, coordinate 0) and
    coordinate 0's first batch."""
    x, width = b["x"], b["width"]
    b["lower"].copy_(x - width * b["offsets"])
    b["upper"].copy_(b["lower"] + width)
    b["logf0"].copy_(logf(x))
    b["i"].zero_()
    _uni_coordinate(b, logf)


def _uni_next(b, logf):
    """The next coordinate, from the log-density where the last one
    ended."""
    b["logf0"].copy_(b["lf"])
    b["i"].add_(1)
    _uni_coordinate(b, logf)


def univariate_bodies(logf_of):
    """The univariate step's bodies on the density ``logf_of(state)``."""
    return {"start": lambda b, s: _uni_start(b, logf_of(s)),
            "next": lambda b, s: _uni_next(b, logf_of(s)),
            "more": lambda b, s: _uni_batch(b, logf_of(s), b["ut"])}


def slice_univariate_step(key, x, tune: SliceTune, logf, graphed=None):
    """Coordinate-wise shrinkage sweep for chains ``x (C, dim)`` (reference
    slice.jl:66-92); ``logf(x) -> (C,)``.  ``graphed``: the captured
    bodies (``univariate_bodies``) to run, by default the plain loop."""
    cap = graphed or plain(univariate_bodies, logf)
    C, n = x.shape
    f = dict(dtype=x.dtype, device=x.device)
    offsets = R.uniform(key, (n,), x.dtype, fold=0)
    u = R.uniform(key, (n, TRIPS + 2), x.dtype, fold=1).permute(1, 2, 0)
    if not cap.holds("x", x):
        zeros = torch.zeros(C, **f)
        flags = torch.zeros(C, dtype=torch.bool, device=x.device)
        cap.load(lower=x, upper=x, logf0=zeros, lf=zeros, p0=zeros, xi=zeros,
                 xi_old=zeros, lo=zeros, hi=zeros, active=flags,
                 trips=torch.zeros(C, dtype=torch.int32, device=x.device),
                 more=torch.zeros((), dtype=torch.bool, device=x.device),
                 i=torch.zeros(1, dtype=torch.long, device=x.device),
                 cols=torch.arange(n, device=x.device),
                 col=torch.zeros(n, dtype=torch.bool, device=x.device),
                 ut=torch.zeros(TRIPS, C, **f))
    cap.load(x=x, width=tune.width, offsets=offsets, u=u)

    for i in range(n):
        def draw(j, i=i):
            cap.bufs["ut"].copy_(R.uniform(key, (TRIPS,), x.dtype,
                                           fold=2 + i * _batches() + j).T)

        graphs.until_done(cap, "start" if i == 0 else "next", "more",
                          _batches(), draw)
    return cap.bufs["x"].clone(), None


# ---------------------------------------------------------------------------
# multivariate
# ---------------------------------------------------------------------------

def _multi_trip(b, logf, u):
    """One joint shrink trip for every chain still shrinking, on the
    uniforms ``u (C, dim)``; a chain at ``MAX_SHRINK`` trips goes back to
    its entry point and stops."""
    active, y, x = b["active"], b["y"], b["x"]
    a = active[:, None]
    left = y < x
    lo = torch.where(a & left, y, b["lo"])
    hi = torch.where(a & ~left, y, b["hi"])
    y2 = torch.where(a, lo + (hi - lo) * u, y)
    lf = torch.where(active, logf(y2), b["lf"])
    trips = b["trips"] + active.to(torch.int32)
    hit = trips >= MAX_SHRINK
    b["active"].copy_(active & (lf < b["p0"]) & ~hit)
    b["lo"].copy_(lo)
    b["hi"].copy_(hi)
    b["y"].copy_(torch.where(hit[:, None], x, y2))
    b["lf"].copy_(lf)
    b["trips"].copy_(trips)


def _multi_batch(b, logf, us):
    for k in range(us.shape[0]):
        if graphs.idle(b["active"]):
            break
        _multi_trip(b, logf, us[k])
    b["more"].copy_(b["active"].any())


def _multi_start(b, logf):
    """The slice level, bracket, first candidate and its density, then the
    first batch of trips."""
    x, width, u = b["x"], b["width"], b["u"]
    p0 = logf(x) + torch.log(b["level"])
    lo = x - width * u[0]
    y = lo + width * u[1]
    lf = logf(y)
    b["p0"].copy_(p0)
    b["lo"].copy_(lo)
    b["hi"].copy_(lo + width)
    b["y"].copy_(y)
    b["lf"].copy_(lf)
    b["active"].copy_(lf < p0)
    b["trips"].zero_()
    _multi_batch(b, logf, u[2:])


def multivariate_bodies(logf_of):
    """The multivariate step's bodies on the density ``logf_of(state)``."""
    return {"start": lambda b, s: _multi_start(b, logf_of(s)),
            "more": lambda b, s: _multi_batch(b, logf_of(s), b["ut"])}


def slice_multivariate_step(key, x, tune: SliceTune, logf, graphed=None):
    """Joint shrinkage step for chains ``x (C, dim)`` (reference
    slice.jl:95-117).  ``graphed``: the captured bodies
    (``multivariate_bodies``) to run, by default the plain loop."""
    cap = graphed or plain(multivariate_bodies, logf)
    C = x.shape[0]
    f = dict(dtype=x.dtype, device=x.device)
    level = R.uniform(key, (), x.dtype, fold=0)
    u = R.uniform(key, (TRIPS + 2,) + x.shape[1:], x.dtype, fold=1).transpose(0, 1)
    if not cap.holds("x", x):
        zeros = torch.zeros(C, **f)
        cap.load(lo=x, hi=x, y=x, p0=zeros, lf=zeros,
                 active=torch.zeros(C, dtype=torch.bool, device=x.device),
                 trips=torch.zeros(C, dtype=torch.int32, device=x.device),
                 more=torch.zeros((), dtype=torch.bool, device=x.device),
                 ut=torch.zeros((TRIPS,) + x.shape, **f))
    cap.load(x=x, width=tune.width, level=level, u=u)

    def draw(j):
        cap.bufs["ut"].copy_(R.uniform(key, (TRIPS,) + x.shape[1:], x.dtype,
                                       fold=1 + j).transpose(0, 1))

    graphs.until_done(cap, "start", "more", _batches(), draw)
    return cap.bufs["y"].clone(), None


class Slice(SamplerSpec):
    """Slice(params, width, form='multivariate'|'univariate',
    transform=False) — reference slice.jl:47-58.  In the engine its
    bodies are replayed from CUDA graphs."""

    def __init__(self, params, width, form: str = "multivariate",
                 transform: bool = False):
        super().__init__(params)
        if form not in ("univariate", "multivariate"):
            raise ValueError("form must be 'univariate' or 'multivariate'")
        self.width = width
        self.form = form
        self.transform = bool(transform)

    def _bodies(self):
        return (univariate_bodies if self.form == "univariate"
                else multivariate_bodies)

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density: captured(self._bodies(), density))

    def kernel_init(self, key, x0, logf):
        return slice_init(x0, self.width)

    def kernel_step(self, key, x, tune, logf, adapt, graphed=None):
        step = (slice_univariate_step if self.form == "univariate"
                else slice_multivariate_step)
        return step(key, x, tune, logf, graphed=graphed)[0], tune
