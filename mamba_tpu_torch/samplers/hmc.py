"""Hamiltonian Monte Carlo with a fixed trajectory, batched over chains
(reference src/samplers/hmc.jl).

Every chain runs the same ``L`` leapfrog steps, so the trajectory is ``L``
batched gradient evaluations with no masking.  The step is three bodies on
tensors of their own (``utils.graphs.Captured``): the start (momentum,
gradient, first half step), one leapfrog, run ``L`` times, and the end (the
last half step undone and the MH test); the engine replays each from a
CUDA graph, the stand-alone step runs them eagerly.  Random draws per step,
draw ``i`` from ``fold_in(key, i)`` of the block's per-chain keys, both
before the start: the momentum noise ``(C, dim)`` and one
acceptance uniform per chain.

With unit mass a block may hold some sites as a data rank's slice
(``coords``, a ``parallel.mesh.BlockCoords``): the momentum noise is drawn
at the unsharded flat length and cut, and the kinetic energies' sums over
coordinates are completed over the data group.  A dense ``Sigma`` mixes
the coordinates, so such a block keeps every site whole.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..ops import random as R
from ..parallel.mesh import WHOLE
from .base import SamplerSpec, captured, mh_select, plain


class HMCTune(NamedTuple):
    epsilon: torch.Tensor           # 0-d step size
    L: int                          # leapfrog steps
    SigmaL: Optional[torch.Tensor]  # (dim, dim) lower Cholesky factor, None = I


def _cholesky(Sigma, like):
    if Sigma is None:
        return None
    return torch.linalg.cholesky(torch.as_tensor(Sigma, dtype=like.dtype,
                                                 device=like.device))


def hmc_init(x0, epsilon, L, Sigma=None) -> HMCTune:
    return HMCTune(epsilon=torch.as_tensor(epsilon, dtype=x0.dtype, device=x0.device),
                   L=int(L), SigmaL=_cholesky(Sigma, x0))


def _sqnorm_Linv(SigmaL, *vs, coords=WHOLE):
    """Per chain ``|SigmaL^-1 v|^2`` for rows ``v (C, dim)`` of each of
    ``vs``, a tuple; with unit mass (``SigmaL`` None) summed over the
    block's ``coords`` (one all-reduce for all on a data rank)."""
    if SigmaL is None:
        return coords.sums(*(v * v for v in vs))
    out = []
    for v in vs:
        w = torch.linalg.solve_triangular(SigmaL, v.T, upper=False)
        out.append(torch.sum(w * w, dim=0))
    return tuple(out)


def _start(b, logfgrad):
    """Momentum p0 = SigmaL z, the gradient at x and the first half step."""
    x, z, L = b["x"], b["z"], b.get("SigmaL")
    p0 = z if L is None else z @ L.T
    logf0, grad0 = logfgrad(x)
    b["p0"].copy_(p0)
    b["logf0"].copy_(logf0)
    b["p"].copy_(p0 + 0.5 * b["eps"] * grad0)
    b["x1"].copy_(x)
    b["logf1"].copy_(logf0)
    b["grad1"].copy_(grad0)


def _leapfrog(b, logfgrad):
    """One leapfrog step (position first, then a full momentum step)."""
    eps = b["eps"]
    x1 = b["x1"] + eps * b["p"]
    logf1, grad1 = logfgrad(x1)
    b["p"].copy_(b["p"] + eps * grad1)
    b["x1"].copy_(x1)
    b["logf1"].copy_(logf1)
    b["grad1"].copy_(grad1)


def _end(b, coords=WHOLE):
    """The extra half step undone (hmc.jl:96) and the MH test on
    ``b["u"]``: the new positions in ``b["out"]``."""
    L = b.get("SigmaL")
    p1 = b["p"] - 0.5 * b["eps"] * b["grad1"]
    sq0, sq1 = _sqnorm_Linv(L, b["p0"], p1, coords=coords)
    K0, K1 = 0.5 * sq0, 0.5 * sq1
    x2, _ = mh_select(b["u"], (b["logf1"] - K1) - (b["logf0"] - K0), b["x1"],
                      b["x"])
    b["out"].copy_(x2)


def trajectory_bodies(logfgrad_of, coords=WHOLE):
    """The step's bodies on the density and gradient ``logfgrad_of(state)``,
    summing over the block's ``coords``."""
    return {"start": lambda b, s: _start(b, logfgrad_of(s)),
            "leapfrog": lambda b, s: _leapfrog(b, logfgrad_of(s)),
            "end": lambda b, s: _end(b, coords)}


def hmc_step(key, x, tune: HMCTune, logfgrad, graphed=None, coords=WHOLE):
    """Fixed-length leapfrog + MH accept (reference hmc.jl:72-111): momentum
    p = SigmaL z, z ~ N(0, I); kinetic energy 0.5 |SigmaL^-1 p|^2.
    ``graphed``: the captured bodies (``trajectory_bodies``), by default the
    plain loop; ``coords``: the block's coordinates on a data rank (unit
    mass)."""
    f = dict(dtype=x.dtype, device=x.device)
    cap = graphed or plain(functools.partial(trajectory_bodies, coords=coords),
                           logfgrad)
    z = coords.randn(key, x, fold=0)
    u = R.uniform(key, (), x.dtype, fold=1)
    if not cap.holds("x", x):
        zeros = torch.zeros(x.shape[:1], **f)
        cap.load(p0=x, p=x, x1=x, grad1=x, out=x, logf0=zeros, logf1=zeros)
    cap.load(x=x, z=z, u=u, eps=tune.epsilon)
    if tune.SigmaL is not None:
        cap.load(SigmaL=tune.SigmaL)
    cap.run(1, "start")
    cap.run(tune.L, "leapfrog")
    cap.run(1, "end")
    return cap.bufs["out"].clone(), tune


class HMC(SamplerSpec):
    """HMC(params, epsilon, L; Sigma=None) — reference hmc.jl:47-58.  With
    unit mass its block can hold sites as a data rank's slice; a dense
    ``Sigma`` mixes the coordinates, and keeps them whole."""

    transform = True
    needs_grad = True
    holds_slices = True

    def __init__(self, params, epsilon, L, Sigma=None):
        super().__init__(params)
        self.epsilon = epsilon
        self.L = L
        self.Sigma = Sigma
        self.holds_slices = Sigma is None

    def build(self, cm):
        return self.bind(cm, self.kernel_init, self.kernel_step,
                         graphed=lambda density, coords=WHOLE: captured(
                             functools.partial(trajectory_bodies,
                                               coords=coords),
                             density, grad=True))

    def kernel_init(self, key, x0, logfgrad, coords=WHOLE):
        return hmc_init(x0, self.epsilon, self.L, self.Sigma)

    def kernel_step(self, key, x, tune, logfgrad, adapt, graphed=None,
                    coords=WHOLE):
        return hmc_step(key, x, tune, logfgrad, graphed=graphed, coords=coords)
