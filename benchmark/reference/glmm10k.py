"""Plain reference of the non-centered Bernoulli-logit GLMM.

    y[g, i] ~ Bernoulli(sigmoid(x[g, i, :] @ beta + b[g]))
    b[g]    = sqrt(s2) * z[g],   z[g] ~ Normal(0, 1)
    beta    ~ Normal(0, 10)   (variance)
    s2      ~ InverseGamma(2, 2)

The gradient block is (beta, z, s2), s2 in log space: its log-density is
the likelihood, the three priors and the log-Jacobian u of s2 = exp(u).
The data generator is a frozen copy of ``mamba_tpu_torch/models/glmm.py``'s
(``build``, commit fc13fd826c36831480dadd26fb8e0f34af6cabfa): numpy's
generator at the configuration's ``data_seed`` (``bench.py``'s data set),
so that every run samples the same posterior.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = {"beta": "identity", "s2": "log", "z": "identity"}
STATE_SITES = ("beta", "s2")
BETA_VAR = 10.0
IG_A, IG_B = 2.0, 2.0


def make_data(config: dict, seed: int) -> dict:
    """x (G, n, P) and y (G, n) from ``numpy.random.default_rng`` at the
    configuration's ``data_seed``; the run's seed drives the chains."""
    G, n, P = config["G"], config["n"], config["P"]
    rng = np.random.default_rng(config["data_seed"])
    beta_true = np.asarray(config["beta_true"], dtype=np.float64)
    b_true = rng.normal(0, np.sqrt(config["s2_true"]), G)
    x = rng.normal(0, 1, (G, n, P))
    logits = x @ beta_true + b_true[:, None]
    y = (rng.random((G, n)) < 1 / (1 + np.exp(-logits))).astype(float)
    return {"x": x, "y": y}


def block_logp_grad(data, parts, values, dtype, device):
    """``(lp (C,), {site: grad (C, size)})`` at the block coordinates
    ``parts``: beta (C, P), z (C, G) and u = log s2 (C, 1)."""
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    x, y = t(data["x"]), t(data["y"])                        # (G, n, P), (G, n)
    G, n, P = x.shape
    beta, z, u = t(parts["beta"]), t(parts["z"]), t(parts["s2"])[:, :1]
    sd = torch.exp(0.5 * u)                                  # (C, 1)
    b = sd * z                                               # (C, G)
    l = torch.einsum("gip,cp->cgi", x, beta) + b[:, :, None]  # (C, G, n)
    loglik = torch.sum(y * l - torch.nn.functional.softplus(l), dim=(1, 2))
    r = y - torch.sigmoid(l)
    rs = torch.sum(r, dim=2)                                 # (C, G)
    lp = (loglik
          - 0.5 * torch.sum(beta * beta, dim=1) / BETA_VAR
          - 0.5 * P * math.log(2.0 * math.pi * BETA_VAR)
          - 0.5 * torch.sum(z * z, dim=1) - 0.5 * G * math.log(2.0 * math.pi)
          + (IG_A * math.log(IG_B) - math.lgamma(IG_A))
          - IG_A * u[:, 0] - IG_B * torch.exp(-u[:, 0]))     # prior + Jacobian
    grads = {
        "beta": torch.einsum("cgi,gip->cp", r, x) - beta / BETA_VAR,
        "z": sd * rs - z,
        "s2": (0.5 * torch.sum(rs * b, dim=1, keepdim=True)
               - IG_A + IG_B * torch.exp(-u)),
    }
    return lp, grads


def monitored(data, values, dtype, device):
    """beta[1..P] and s2 of every chain from its constrained state."""
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    beta = t(values["beta"])
    out = {f"beta[{i + 1}]": beta[:, i] for i in range(beta.shape[1])}
    out["s2"] = t(values["s2"]).reshape(-1)
    return out


def in_support(label: str, x: np.ndarray) -> np.ndarray:
    ok = np.isfinite(x)
    return ok & (x > 0) if label == "s2" else ok


def gradient_flops(config: dict, chains: int) -> float:
    """Float32 operations of one likelihood-and-gradient evaluation for all
    chains, counted from the shapes (frozen ``glmm_work``): the model's
    work, whatever implements it."""
    from benchmark.frozen.glmm_work import glmm_work
    return float(glmm_work(config["P"], config["n"], config["G"], chains)["flops"])
