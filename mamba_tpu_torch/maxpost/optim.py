"""MAP estimation over model parameters.

Counterpart of the JAX package's ``maxpost/optim.py`` and, through it, of
the fork's experimental src/maxpost/maxpost.jl: ``optimOver(m, init,
params)`` maximizes ``logpdf(m)`` with BFGS and ForwardDiff dual numbers
(maxpost.jl:40-50).  Here the compiled block log-density is differentiated
by autograd and maximized in the link-transformed (unconstrained) space, so
bounded parameters need no box constraints, on the model's device.

Methods: ``lbfgs`` (10 pairs) and ``bfgs`` (dense inverse Hessian) are
quasi-Newton iterations written here, which stop at ``maxiter`` or once
converged; each step backtracks until the Armijo condition holds at a
finite value and gradient.  (The JAX package runs optax's L-BFGS for a
fixed ``maxiter`` and ``jax.scipy``'s BFGS; ``torch.optim.LBFGS``'s
strong-Wolfe search was not taken, because its step turns NaN where a
float32 density overflows to -inf, as the full-width GLMM's does.)
``adam`` is ``torch.optim.Adam`` for ``maxiter`` steps at ``lr``, the same
iterates as optax's Adam.  Parity with the JAX package is on the optimum.
``converged`` is this package's own test: the largest gradient coordinate
at the optimum is at most ``GTOL`` times max(1, |log-density|).  (The JAX
package reports ``converged=True`` for ``lbfgs`` and ``adam`` whatever
happened.)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..model.compile import compile_model
from ..model.model import Model

#: the convergence test's relative gradient size, which also ends the
#: quasi-Newton iteration
GTOL = 1e-9
#: halvings of a quasi-Newton step before its direction is given up
MAX_HALVINGS = 10


@dataclasses.dataclass
class MAPResult:
    params: dict[str, Any]        # constrained MAP values per site (numpy)
    logpdf: float                 # joint log-density at the optimum
    converged: bool
    niter: int

    def as_inits(self, data: dict) -> dict:
        """Merge with observed data for warm-starting ``mcmc`` (the fork's
        stated intent: MAP warm-start, SURVEY.md §2.6)."""
        out = dict(data)
        out.update({k: np.asarray(v) for k, v in self.params.items()})
        return out


def _value_and_grad(neg, x):
    x = x.detach().requires_grad_(True)
    f = neg(x)
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def _small(f, g) -> bool:
    """The convergence test: max |gradient| <= GTOL * max(1, |f|)."""
    return bool(torch.isfinite(f)) and \
        float(g.abs().max()) <= GTOL * max(1.0, abs(float(f)))


def _two_loop(g, pairs):
    """L-BFGS direction ``-H g`` from the stored ``(s, y, 1 / s.y)`` pairs,
    the initial inverse Hessian scaled by the newest pair's s.y / y.y."""
    q = g.clone()
    alphas = []
    for s, y, rho in reversed(pairs):
        a = rho * float(s @ q)
        q -= a * y
        alphas.append(a)
    s, y, rho = pairs[-1]
    r = q / (rho * float(y @ y))
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        r += (a - rho * float(y @ r)) * s
    return -r


def _quasi_newton(neg, x0, maxiter: int, memory: int | None):
    """Minimize ``neg`` from ``x0``: dense BFGS on the inverse Hessian
    (``memory=None``) or L-BFGS keeping ``memory`` pairs.  Each step
    backtracks from t = 1 until the Armijo condition holds at a finite
    value and gradient (a float32 density that overflows far out only
    shortens the step); a step whose curvature s.y is not positive leaves
    the Hessian estimate as it was.  Where ``MAX_HALVINGS`` halvings find
    no step, the Hessian estimate is dropped and the next step is steepest
    descent; the iteration stops once the gradient test holds, or once
    steepest descent finds no step either: ``neg``'s rounding (float32 sums
    of 10^5 terms) then hides what is left to gain.  Returns (x,
    iterations)."""
    x = x0.detach().clone()
    f, g = _value_and_grad(neg, x)
    eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device) \
        if memory is None else None
    H = eye
    pairs: list = []

    def fresh() -> bool:
        """No curvature kept: the step is steepest descent."""
        return H is eye if memory is None else not pairs

    for it in range(maxiter):
        if _small(f, g):
            return x, it
        if memory is None:
            p = -(H @ g)
        elif pairs:
            p = _two_loop(g, pairs)
        else:
            p = -g
        if not float(g @ p) < 0.0:         # not a descent direction: restart
            H, p = eye, -g
            pairs.clear()
        if fresh():
            p = p * min(1.0, 1.0 / float(g.abs().sum()))  # first step's length
        slope = float(g @ p)
        for halvings in range(MAX_HALVINGS):
            t = 0.5 ** halvings
            x1 = x + t * p
            f1, g1 = _value_and_grad(neg, x1)
            if (bool(torch.isfinite(f1)) and bool(torch.isfinite(g1).all())
                    and float(f1) <= float(f) + 1e-4 * t * slope):
                break
        else:
            if fresh():
                return x, it
            H = eye                        # retry from steepest descent
            pairs = []
            continue
        s, y = x1 - x, g1 - g
        sy = float(s @ y)
        if sy > 1e-10 * float(torch.linalg.vector_norm(s)
                              * torch.linalg.vector_norm(y)):
            if memory is None:
                A = eye - torch.outer(s, y) / sy
                H = A @ H @ A.T + torch.outer(s, s) / sy
            else:
                pairs = (pairs + [(s, y, 1.0 / sy)])[-memory:]
        x, f, g = x1, f1, g1
    return x, maxiter


def optim_over(model: Model, inputs: dict, inits: dict, params=None, *,
               method: str = "lbfgs", maxiter: int = 500, lr: float = 1e-2,
               device=None, dtype=None) -> MAPResult:
    """Maximize the joint log-density over ``params`` (default: every
    sampled/free stochastic node that is not observed data) on ``device``
    (required, as for ``mcmc``).

    ``method``: 'lbfgs' (default), 'adam' or 'bfgs' (module docstring)."""
    if device is None:
        raise ValueError("optim_over needs an explicit device (e.g. 'cuda' "
                         "or 'cpu')")
    if method not in ("lbfgs", "adam", "bfgs"):
        raise ValueError(f"unknown method {method!r}")
    cm = compile_model(model, inputs, inits, device=device, dtype=dtype)
    if params is None:
        # default: sampled (free) nodes when a scheme is set, else everything
        observed = set(model.keys("observed")) if model.samplers else set()
        params = [n for n in cm.stochastic if n not in observed]
    params = tuple([params] if isinstance(params, str) else params)

    pack, unpack, _, logf = cm.block_functions(params, transform=True)
    state0 = {n: cm.tensor(np.broadcast_to(np.asarray(inits[n], dtype=np.float64),
                                           cm.sites[n].shape))
              for n in cm.stochastic}
    x0 = pack(state0).detach()

    def neg(x):
        return -logf(x, state0)

    if method == "adam":
        x = x0.clone().requires_grad_(True)
        opt = torch.optim.Adam([x], lr=lr)
        for _ in range(maxiter):
            opt.zero_grad()
            neg(x).backward()
            opt.step()
        x, nit = x.detach(), maxiter
    else:
        x, nit = _quasi_newton(neg, x0, maxiter,
                               memory=10 if method == "lbfgs" else None)
    converged = _small(*_value_and_grad(neg, x))
    with torch.no_grad():
        values = unpack(x, state0)
        lp = float(cm.logpdf({**state0, **values}))
    return MAPResult(params={k: v.cpu().numpy() for k, v in values.items()},
                     logpdf=lp, converged=converged, niter=nit)
