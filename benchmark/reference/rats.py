"""Plain reference of the rats growth model (Gelfand et al. 1990; BUGS
Examples Vol. I "Rats"; Mamba's doc/examples/rats).

    y[i, j]  ~ Normal(alpha[i] + beta[i] * (x[j] - xbar), s2_c)
    alpha[i] ~ Normal(mu_alpha, s2_alpha)
    beta[i]  ~ Normal(mu_beta, s2_beta)
    mu_alpha, mu_beta ~ Normal(0, 1000^2);  s2_* ~ InverseGamma(0.001, 0.001)
    alpha0 = mu_alpha - xbar * mu_beta

(variances as the second argument).  The gradient block is the NUTS
block: alpha, beta, mu_alpha, mu_beta, all unconstrained; the three
variances are constants of its density.  Its log-density holds the terms
that read the block: y, alpha, beta and the two means' priors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = {"alpha": "identity", "beta": "identity", "mu_alpha": "identity",
         "mu_beta": "identity"}
#: the constrained state sites the reference reads
STATE_SITES = ("mu_alpha", "mu_beta", "s2_c", "s2_alpha", "s2_beta")
PRIOR_VAR = 1000.0 ** 2


def make_data(config: dict, seed: int) -> dict:
    """The published data: weights y (rats, weeks) and ages x (days); the
    seed does not change them."""
    y = np.asarray(config["data"]["y"], dtype=np.float64)
    x = np.asarray(config["data"]["x"], dtype=np.float64)
    if y.shape != (config["rats"], config["weeks"]) or x.shape != (config["weeks"],):
        raise ValueError(f"rats data of shape {y.shape}, {x.shape}")
    return {"y": y, "x": x}


def _normal_lp(x, mean, var):
    return -0.5 * torch.log(2.0 * math.pi * var) - 0.5 * (x - mean) ** 2 / var


def block_logp_grad(data, parts, values, dtype, device):
    """``(lp (C,), {site: grad (C, size)})`` at the block coordinates
    ``parts`` ({site: (C, size)}) with the variances of ``values``."""
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    y, x = t(data["y"]), t(data["x"])
    xm = x - torch.mean(x)
    alpha, beta = t(parts["alpha"]), t(parts["beta"])
    mu_a, mu_b = t(parts["mu_alpha"])[:, :1], t(parts["mu_beta"])[:, :1]
    s2_c = t(values["s2_c"]).reshape(-1, 1)
    s2_a = t(values["s2_alpha"]).reshape(-1, 1)
    s2_b = t(values["s2_beta"]).reshape(-1, 1)
    fit = alpha[:, :, None] + beta[:, :, None] * xm          # (C, rats, weeks)
    e = y - fit
    lp = (torch.sum(_normal_lp(y, fit, s2_c[:, :, None]), dim=(1, 2))
          + torch.sum(_normal_lp(alpha, mu_a, s2_a), dim=1)
          + torch.sum(_normal_lp(beta, mu_b, s2_b), dim=1)
          + _normal_lp(mu_a, 0.0, t(PRIOR_VAR))[:, 0]
          + _normal_lp(mu_b, 0.0, t(PRIOR_VAR))[:, 0])
    da = (alpha - mu_a) / s2_a
    db = (beta - mu_b) / s2_b
    grads = {
        "alpha": torch.sum(e, dim=2) / s2_c - da,
        "beta": torch.sum(e * xm, dim=2) / s2_c - db,
        "mu_alpha": torch.sum(da, dim=1, keepdim=True) - mu_a / PRIOR_VAR,
        "mu_beta": torch.sum(db, dim=1, keepdim=True) - mu_b / PRIOR_VAR,
    }
    return lp, grads


def monitored(data, values, dtype, device):
    """alpha0, mu_beta and s2_c of every chain from its constrained state."""
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device).reshape(-1)
    xbar = float(np.mean(data["x"]))
    mu_a, mu_b = t(values["mu_alpha"]), t(values["mu_beta"])
    return {"alpha0": mu_a - t(xbar) * mu_b, "mu_beta": mu_b,
            "s2_c": t(values["s2_c"])}


#: the inverse-gamma prior of each variance, shape and scale
IG_PRIOR = (0.001, 0.001)


def gibbs_pit(data, parts, values) -> dict:
    """Each variance's final draw as a probability-integral transform under
    its conjugate conditional given the final effects, in float64:

        s2_c     | alpha, beta ~ InverseGamma(a + rats*weeks/2, b + SSE/2)
        s2_alpha | alpha, mu_alpha ~ InverseGamma(a + rats/2,
                                                  b + sum (alpha - mu_alpha)^2 / 2)
        s2_beta  | beta, mu_beta  (the same)

    and P(s2 <= s) = Q(shape, scale / s), the regularized upper incomplete
    gamma function.  ``parts`` are the block's flat coordinates and
    ``values`` the constrained state, (C, ...) host arrays."""
    f = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float64)
    y, x = f(data["y"]), f(data["x"])
    xm = x - torch.mean(x)
    alpha, beta = f(parts["alpha"]), f(parts["beta"])
    mu_a, mu_b = f(parts["mu_alpha"])[:, :1], f(parts["mu_beta"])[:, :1]
    a0, b0 = IG_PRIOR
    rats, weeks = y.shape
    sse = torch.sum((y - alpha[:, :, None] - beta[:, :, None] * xm) ** 2, dim=(1, 2))
    cond = {"s2_c": (a0 + 0.5 * rats * weeks, b0 + 0.5 * sse),
            "s2_alpha": (a0 + 0.5 * rats,
                         b0 + 0.5 * torch.sum((alpha - mu_a) ** 2, dim=1)),
            "s2_beta": (a0 + 0.5 * rats,
                        b0 + 0.5 * torch.sum((beta - mu_b) ** 2, dim=1))}
    out = {}
    for n, (shape, scale) in cond.items():
        s = f(values[n]).reshape(-1)
        out[n] = torch.special.gammaincc(torch.full_like(s, shape),
                                         scale / s).numpy()
    return out


def in_support(label: str, x: np.ndarray) -> np.ndarray:
    ok = np.isfinite(x)
    return ok & (x > 0) if label.startswith("s2") else ok
