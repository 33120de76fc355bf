"""Inputs and error measures with which the fused GLMM kernel is held against
its plain version: ``chip_smoke.py``, ``glmm_kernel_lab.py`` and the tests
share them.  Nothing on the sampling path imports this module."""

from __future__ import annotations

import numpy as np

from ..models import glmm


def random_inputs(P: int, n: int, G: int, C: int, seed: int):
    """Standard-normal covariates, fair-coin responses and every chain far
    from any mode, as numpy float64 arrays ``(Xt, y, betas, bs)``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (P, n, G)),
            (rng.random((n, G)) < 0.5).astype(np.float64),
            rng.normal(0, 0.5, (C, P)), rng.normal(0, 0.7, (C, G)))


def near_mode_inputs(G: int, C: int, seed: int, n: int = 10):
    """Inputs at which ``grad_beta`` cancels, as numpy float64 arrays
    ``(Xt, y, betas, bs)``: the data of ``models.glmm.build(G, n, fused=True)``
    with every chain close to the parameters that generated it, ``betas`` =
    truth + N(0, 0.01^2) and ``bs`` = truth + N(0, 0.05^2).  Near a posterior
    mode the sum over 10^5 residuals is far smaller than the sum of their
    sizes, which is where an absolute error in ``sigmoid`` shows."""
    _, inputs, inits, truth = glmm.build(G, n=n, fused=True)
    rng = np.random.default_rng(seed)
    betas = truth["beta"] + rng.normal(0, 0.01, (C, truth["beta"].size))
    bs = truth["b"] + rng.normal(0, 0.05, (C, G))
    return inputs["xt"], inits[0]["y"], betas, bs


def glmm_errors(out, ref) -> dict:
    """How far ``out = (lp, grad_beta, grad_b)`` lies from a float64
    reference: ``lp_rel_err`` (max relative), ``grad_rel_err`` (max |diff|
    over both gradients, over max |reference|: the gradient scale),
    ``grad_max_abs_err``, and ``gbeta_rel_err`` for grad_beta on its own."""
    (lp, gbeta, gb), (lp_r, gbeta_r, gb_r) = out, ref
    gmax = max(gbeta_r.abs().max().item(), gb_r.abs().max().item())
    dbeta = (gbeta.double() - gbeta_r).abs().max().item()
    gabs = max(dbeta, (gb.double() - gb_r).abs().max().item())
    return {"lp_rel_err": ((lp.double() - lp_r).abs() / lp_r.abs()).max().item(),
            "grad_rel_err": gabs / gmax, "grad_max_abs_err": gabs,
            "gbeta_rel_err": dbeta / gbeta_r.abs().max().item()}
