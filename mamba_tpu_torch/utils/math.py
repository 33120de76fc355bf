"""Math utilities (reference src/utils.jl:45-81): logit/invlogit and running
means."""

from __future__ import annotations

import numpy as np
import torch


def invlogit(x):
    """1 / (1 + exp(-x)) (reference utils.jl:63-64)."""
    x = torch.as_tensor(x)
    return 1.0 / (torch.exp(-x) + 1.0)


def logit(x):
    """log(x / (1 - x)) (reference utils.jl:66-67)."""
    x = torch.as_tensor(x)
    return torch.log(x / (1.0 - x))


def cummean(x):
    """Running means over the leading axis (reference utils.jl:50-60)."""
    from ..output.stats import cummean_arr
    return cummean_arr(np.asarray(x))


_BETAINC_ROUNDS = 200
_TINY = 1e-300


def betainc(a, b, x):
    """Regularized incomplete beta function ``I_x(a, b)`` in plain torch
    (``torch.special`` has none): Lentz's evaluation of the continued
    fraction with a fixed number of rounds, taken at ``1 - x`` with the
    parameters swapped where ``x > (a + 1) / (a + b + 2)`` so that it
    converges fast everywhere.  Elementwise over broadcastable tensors,
    differentiable in all three arguments through the rounds.  Agrees with
    ``scipy.special.betainc`` to a relative 1e-10 in float64 for ``a, b`` in
    [0.05, 8000] (the tests hold it to that); the fraction needs about
    ``sqrt(max(a, b))`` rounds, so far larger parameters would need more
    than the fixed count."""
    x = torch.as_tensor(x)
    dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
    a = torch.as_tensor(a, dtype=dtype, device=x.device)
    b = torch.as_tensor(b, dtype=dtype, device=x.device)
    a, b, x = torch.broadcast_tensors(a, b, x.to(dtype))
    tiny = _TINY if dtype == torch.float64 else 1e-30
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)

    def guard(v):
        return torch.where(torch.abs(v) < tiny, torch.full_like(v, tiny), v)

    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 / guard(1.0 - qab * xx / qap)
    h = d
    for m in range(1, _BETAINC_ROUNDS + 1):
        m2 = 2.0 * m
        t = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 / guard(1.0 + t * d)
        c = guard(1.0 + t / c)
        h = h * d * c
        t = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + t * d)
        c = guard(1.0 + t / c)
        h = h * d * c
    log_front = (torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
                 + torch.xlogy(aa, xx) + torch.special.xlog1py(bb, -xx))
    val = torch.exp(log_front) * h / aa
    return torch.where(swap, 1.0 - val, val)
