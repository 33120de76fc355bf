"""Support bijectors: unconstrained <-> constrained transforms with log-Jacobians.

Counterpart of the reference's link/invlink/logpdf(transform=true) table
(reference: src/distributions/transformdistribution.jl:6-93 and
src/distributions/pdmatdistribution.jl:27-63).  Each bijector is a frozen
dataclass; ``forward`` maps unconstrained -> constrained (reference
``invlink``), ``inverse`` maps back (reference ``link``), and
``forward_log_det`` is the log |d forward / du| that gets *added* to the
constrained log-density so that samplers run on an unconstrained Euclidean
space.

Every map is written out-of-place on tensors, so it composes with
``torch.func.vmap`` over chains and ``torch.func.grad``.
"""

from __future__ import annotations

import dataclasses

import torch


def softplus(x):
    """log(1 + exp(x)) without overflow, the same formula as
    ``jax.nn.softplus`` (torch's ``F.softplus`` linearizes above a
    threshold instead)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _bcast(ld, *others):
    shape = torch.broadcast_shapes(ld.shape, *(torch.as_tensor(o).shape
                                               for o in others))
    return ld.expand(shape)


class Bijector:
    """unconstrained u -> constrained x.  Subclasses define forward/inverse/
    forward_log_det and (for shape-changing maps) unconstrained_shape."""

    def unconstrained_shape(self, event_shape: tuple[int, ...]) -> tuple[int, ...]:
        return event_shape

    def forward_log_det(self, u):
        raise NotImplementedError

    # summed log-det over an event of given ndim (0 for scalar/elementwise)
    def event_log_det(self, u, event_ndim: int):
        ld = self.forward_log_det(u)
        if event_ndim == 0:
            return ld
        return torch.sum(ld, dim=tuple(range(-event_ndim, 0)))


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def forward_log_det(self, u):
        return torch.zeros_like(u)


@dataclasses.dataclass(frozen=True)
class Exp(Bijector):
    """u -> exp(u); positive support (reference PositiveDistribution log link,
    transformdistribution.jl:66-78)."""

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(x)

    def forward_log_det(self, u):
        return u


@dataclasses.dataclass(frozen=True)
class LowerBounded(Bijector):
    """u -> lo + exp(u)."""
    lo: torch.Tensor

    def forward(self, u):
        return self.lo + torch.exp(u)

    def inverse(self, x):
        return torch.log(x - self.lo)

    def forward_log_det(self, u):
        return _bcast(u, self.lo)


@dataclasses.dataclass(frozen=True)
class UpperBounded(Bijector):
    """u -> hi - exp(u)."""
    hi: torch.Tensor

    def forward(self, u):
        return self.hi - torch.exp(u)

    def inverse(self, x):
        return torch.log(self.hi - x)

    def forward_log_det(self, u):
        return _bcast(u, self.hi)


@dataclasses.dataclass(frozen=True)
class Sigmoid(Bijector):
    """u -> lo + (hi-lo) * sigmoid(u); bounded support (reference logit link,
    transformdistribution.jl:14-27 & UnitDistribution 83-93)."""
    lo: torch.Tensor
    hi: torch.Tensor

    def forward(self, u):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(u)

    def inverse(self, x):
        p = (x - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)

    def forward_log_det(self, u):
        # log((hi-lo) * sigmoid(u) * (1-sigmoid(u)))
        width = self.hi - self.lo
        # a Python number becomes a tensor by a fill on the device, and a
        # 0-d tensor on the host (Uniform(0, 10)'s bounds) stays there, an
        # operand that the device's operation reads as a number: a copy from
        # the host cannot be captured in a CUDA graph
        if isinstance(width, (int, float)):
            width = torch.full((), width, dtype=u.dtype, device=u.device)
        elif width.device != u.device and width.dim() > 0:
            width = width.to(u.device)
        ld = torch.log(width.to(u.dtype)) - softplus(u) - softplus(-u)
        return _bcast(ld, self.lo, self.hi)


def _stick_offsets(d, like):
    return torch.log(torch.arange(d - 1, 0, -1, dtype=like.dtype,
                                  device=like.device))


@dataclasses.dataclass(frozen=True)
class StickBreaking(Bijector):
    """R^{d-1} -> interior of the (d-1)-simplex (length-d probability vector).

    Stan-style stick-breaking with centering offsets so u=0 maps to the
    uniform simplex point.
    """

    def unconstrained_shape(self, event_shape):
        return event_shape[:-1] + (event_shape[-1] - 1,)

    def forward(self, u):
        z = torch.sigmoid(u - _stick_offsets(u.shape[-1] + 1, u))
        zpad = torch.cat([z, torch.ones_like(z[..., :1])], dim=-1)
        rem = torch.cumprod(1.0 - z, dim=-1)
        rem = torch.cat([torch.ones_like(z[..., :1]), rem], dim=-1)
        return rem * zpad

    def inverse(self, x):
        offsets = _stick_offsets(x.shape[-1], x)
        csum = torch.cumsum(x[..., :-1], dim=-1)
        rem = 1.0 - torch.cat([torch.zeros_like(csum[..., :1]),
                               csum[..., :-1]], dim=-1)
        z = x[..., :-1] / rem
        return torch.log(z) - torch.log1p(-z) + offsets

    def event_log_det(self, u, event_ndim: int):
        v = u - _stick_offsets(u.shape[-1] + 1, u)
        z = torch.sigmoid(v)
        rem = torch.cumprod(1.0 - z, dim=-1)
        rem = torch.cat([torch.ones_like(z[..., :1]), rem[..., :-1]], dim=-1)
        ld = -softplus(v) - softplus(-v) + torch.log(rem)
        ld = torch.sum(ld, dim=-1)
        if event_ndim > 1:
            ld = torch.sum(ld, dim=tuple(range(-(event_ndim - 1), 0)))
        return ld

    def forward_log_det(self, u):
        raise NotImplementedError("use event_log_det")


@dataclasses.dataclass(frozen=True)
class CholeskyPD(Bijector):
    """R^{d(d+1)/2} -> symmetric positive-definite d x d matrix.

    x = L L^T with L lower-triangular, diag(L) = exp(u_diag): the standard
    unconstrained Cholesky parameterization of Wishart/InverseWishart nodes
    (reference pdmatdistribution.jl:5-63 packs the upper triangle instead).
    """
    dim: int

    def unconstrained_shape(self, event_shape):
        d = self.dim
        return event_shape[:-2] + (d * (d + 1) // 2,)

    def _to_L(self, u):
        # scatter the packed lower triangle with a 0/1 placement matrix
        # (a product, not an indexed write, so it batches and differentiates),
        # built by a comparison on the device: no value comes from the host,
        # so the map can be captured in a CUDA graph
        d = self.dim
        rows, cols = torch.tril_indices(d, d, device=u.device)
        place = (torch.arange(d * d, device=u.device)[None, :]
                 == (rows * d + cols)[:, None]).to(u.dtype)
        L = (u @ place).reshape(u.shape[:-1] + (d, d))
        eye = torch.eye(d, dtype=torch.bool, device=u.device)
        return torch.where(eye, torch.exp(torch.where(eye, L, 0.0)), L)

    def forward(self, u):
        L = self._to_L(u)
        return L @ L.transpose(-1, -2)

    def inverse(self, x):
        L = torch.linalg.cholesky(x)
        d = self.dim
        eye = torch.eye(d, dtype=torch.bool, device=x.device)
        L = torch.where(eye, torch.log(torch.where(eye, L, 1.0)), L)
        rows, cols = torch.tril_indices(d, d, device=x.device)
        return L[..., rows, cols]

    def event_log_det(self, u, event_ndim: int):
        # log det J = d*log2 + sum_i (d - i + 2) * u_diag_i  (i 1-based),
        # with L_ii = exp(u_i)
        d = self.dim
        diag_pos = torch.cumsum(torch.arange(d, device=u.device) + 1, 0) - 1
        udiag = u[..., diag_pos]
        i = torch.arange(1, d + 1, dtype=u.dtype, device=u.device)
        ld = (d * torch.log(torch.full((), 2.0, dtype=u.dtype, device=u.device))
              + torch.sum((d - i + 2.0) * udiag, dim=-1))
        if event_ndim > 2:
            ld = torch.sum(ld, dim=tuple(range(-(event_ndim - 2), 0)))
        return ld

    def forward_log_det(self, u):
        raise NotImplementedError("use event_log_det")


@dataclasses.dataclass(frozen=True)
class Discrete(Bijector):
    """Marker bijector for discrete-support nodes: identity map, zero
    Jacobian, flags the site as non-differentiable (excluded from
    gradient-based blocks)."""

    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def forward_log_det(self, u):
        return torch.zeros_like(u)
