"""ADVI: automatic differentiation variational inference.

A mean-field Gaussian over the model's free parameters in link-transformed
(unconstrained) space, fit by stochastic ascent of the reparameterized
ELBO (Kucukelbir et al. 2017) with ``torch.optim.Adam``.  The entropy of a
Gaussian is closed-form, and the log-Jacobians of the support transforms
are already part of the compiled block density, so the ELBO is

    E_{z~q}[ logp(forward(z)) + log|J(z)| ] + H(q).

Each step draws ``nmc`` standard normals ``eps`` (one ``(nmc, dim)`` draw
from the run's generator) and evaluates the block density and its gradient
at ``z = mu + exp(log_sigma) * eps`` with ``vmap(grad_and_value(logf))``,
the same batched call the samplers use.  The reparameterization gradient is
then written out: d/dmu = mean_k g_k and d/dlog_sigma = mean_k g_k * eps_k *
sigma + 1.  The loop runs on the host; the ELBO trace stays on the device
until the end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..model.compile import CompiledModel, compile_model
from ..model.model import Model
from ..utils.pytree import RavelSpec


@dataclasses.dataclass
class ADVIResult:
    mu: torch.Tensor              # variational mean (unconstrained space)
    log_sigma: torch.Tensor       # variational log-stddev
    elbo_trace: np.ndarray        # ELBO before each step
    params: tuple[str, ...]
    _cm: CompiledModel
    _unpack: Callable
    _spec: RavelSpec
    _state0: dict[str, Any]

    def sample(self, gen: torch.Generator, n: int = 1000) -> dict[str, torch.Tensor]:
        """``n`` draws from q in constrained space: {site: (n, ...)}, on the
        model's device.  One ``(n, dim)`` normal draw from ``gen``."""
        z = self.mu + torch.exp(self.log_sigma) * torch.randn(
            (n, self.mu.shape[0]), generator=gen, dtype=self.mu.dtype,
            device=self.mu.device)
        return torch.func.vmap(self._unpack, in_dims=(0, None))(z, self._state0)

    def mean_state(self) -> dict[str, np.ndarray]:
        """q's mode mapped to constrained space — the MCMC warm-start
        payload."""
        vals = self._unpack(self.mu, self._state0)
        return {k: v.cpu().numpy() for k, v in vals.items()}

    def as_inits(self, data: dict) -> dict:
        out = dict(data)
        out.update(self.mean_state())
        return out

    def unconstrained_variances(self) -> dict[str, np.ndarray]:
        """q's per-coordinate variances split by site, in unconstrained
        space — a warm start for a diagonal inverse mass (``minv0``)."""
        parts = self._spec.unravel(torch.exp(2.0 * self.log_sigma))
        return {k: v.cpu().numpy() for k, v in parts.items()}


def _setup(model: Model, inputs: dict, inits: dict, params, *, device, dtype):
    """The compiled model, the fitted block and its functions, and the
    constrained state the block is evaluated against."""
    cm = compile_model(model, inputs, inits, device=device, dtype=dtype)
    if params is None:
        observed = set(model.keys("observed")) if model.samplers else set()
        params = [n for n in cm.stochastic if n not in observed]
    params = tuple([params] if isinstance(params, str) else params)
    pack, unpack, spec, logf = cm.block_functions(params, transform=True)
    state0 = {n: cm.tensor(np.broadcast_to(np.asarray(inits[n], dtype=np.float64),
                                           cm.sites[n].shape))
              for n in cm.stochastic}
    return cm, params, pack, unpack, spec, logf, state0


def _mc_noise(gen, nmc: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    return torch.randn((nmc, dim), generator=gen, dtype=like.dtype,
                       device=like.device)


def advi(model: Model, inputs: dict, inits: dict, params=None, *,
         steps: int = 2000, nmc: int = 8, lr: float = 5e-2, seed: int = 0,
         device, dtype=None) -> ADVIResult:
    """Fit a mean-field Gaussian to the free parameters' posterior
    (``params`` defaults to every stochastic node that no sampler block
    leaves observed).  ``device`` is required; the Monte Carlo noise comes
    from a ``torch.Generator`` on it seeded with ``seed``."""
    if device is None:
        raise ValueError("advi needs an explicit device (e.g. 'cuda' or 'cpu')")
    cm, params, pack, unpack, spec, logf, state0 = _setup(
        model, inputs, inits, params, device=device, dtype=dtype)
    mu = pack(state0).detach().clone()
    d = mu.shape[0]
    log_sigma = torch.full((d,), -2.0, dtype=cm.dtype, device=cm.device)
    grad_value = torch.func.vmap(torch.func.grad_and_value(logf),
                                 in_dims=(0, None))
    entropy_const = 0.5 * d * (1.0 + math.log(2.0 * math.pi))
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(seed)
    opt = torch.optim.Adam([mu, log_sigma], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    trace = torch.empty(steps, dtype=cm.dtype, device=cm.device)
    for i in range(steps):
        eps = _mc_noise(gen, nmc, d, mu)
        sigma = torch.exp(log_sigma)
        g, lp = grad_value(mu + sigma * eps, state0)
        trace[i] = torch.mean(lp) + torch.sum(log_sigma) + entropy_const
        # Adam minimizes: hand it the gradient of -ELBO
        mu.grad = -torch.mean(g, dim=0)
        log_sigma.grad = -(torch.mean(g * eps, dim=0) * sigma + 1.0)
        opt.step()
    return ADVIResult(mu=mu, log_sigma=log_sigma,
                      elbo_trace=trace.cpu().numpy(), params=params, _cm=cm,
                      _unpack=unpack, _spec=spec, _state0=state0)
