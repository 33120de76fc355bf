"""Convergence diagnostics: Gelman-Rubin-Brooks, Geweke, Heidelberger-Welch,
Raftery-Lewis.

Counterpart of reference src/output/gelmandiag.jl, gewekediag.jl,
heideldiag.jl, rafterydiag.jl — identical estimators and output columns,
vectorized over parameters/chains where the math allows.  ``pcramer`` is the
Csorgo-Faraway Cramér-von Mises CDF (reference src/utils.jl:70-80).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import special, stats as sstats

from .chains import Chains
from .chainsummary import ChainSummary
from .stats import _header, mcse


def link_values(c: Chains) -> np.ndarray:
    """Heuristic link transform of stored draws (reference chains.jl:237-246):
    positive columns -> log, unit-interval columns -> logit."""
    cc = np.array(c.value, dtype=float, copy=True)
    for j in range(cc.shape[1]):
        x = cc[:, j, :]
        if x.min() > 0.0:
            cc[:, j, :] = (np.log(x / (1.0 - x)) if x.max() < 1.0
                           else np.log(x))
    return cc


def pcramer(q: float) -> float:
    """P(W <= q) for the Cramér-von Mises statistic (Csorgo & Faraway 1996;
    reference utils.jl:70-80)."""
    p = 0.0
    for k in range(4):
        c1 = 4.0 * k + 1.0
        c2 = c1 ** 2 / (16.0 * q)
        p += (special.gamma(k + 0.5) / math.factorial(k) * np.sqrt(c1)
              * np.exp(-c2) * special.kv(0.25, c2))
    return float(p / (np.pi ** 1.5 * np.sqrt(q)))


# ---------------------------------------------------------------------------
# Gelman, Rubin & Brooks
# ---------------------------------------------------------------------------

def gelmandiag(c: Chains, alpha: float = 0.05, mpsrf: bool = False,
               transform: bool = False) -> ChainSummary:
    """Potential scale reduction factors with sampling-variability correction
    and F-quantile upper bounds; optional multivariate MPSRF (reference
    gelmandiag.jl:3-60)."""
    n, p, m = c.value.shape
    if m < 2:
        raise ValueError("less than 2 chains supplied to gelman diagnostic")
    # c.link() dispatches: ModelChains applies each node's actual bijector
    # (reference modelchains.jl:55-73), plain Chains the positive/unit
    # heuristic (chains.jl:237-246)
    psi = c.link() if transform else np.asarray(c.value, dtype=float)

    S2 = np.stack([np.cov(psi[:, :, k], rowvar=False).reshape(p, p)
                   for k in range(m)], axis=2)       # (p, p, m)
    W = S2.mean(axis=2)
    psibar = psi.mean(axis=0).T                       # (m, p)
    B = n * np.cov(psibar, rowvar=False).reshape(p, p)

    w = np.diag(W)
    b = np.diag(B)
    s2 = np.stack([np.diag(S2[:, :, k]) for k in range(m)])   # (m, p)
    psibar2 = psibar.mean(axis=0)

    var_w = s2.var(axis=0, ddof=1) / m
    var_b = (2.0 / (m - 1)) * b ** 2
    cov_s2_psibar2 = np.array([np.cov(s2[:, i], psibar[:, i] ** 2)[0, 1]
                               for i in range(p)])
    cov_s2_psibar = np.array([np.cov(s2[:, i], psibar[:, i])[0, 1]
                              for i in range(p)])
    var_wb = (n / m) * (cov_s2_psibar2 - 2.0 * psibar2 * cov_s2_psibar)

    V = ((n - 1) / n) * w + ((m + 1) / (m * n)) * b
    var_V = ((n - 1) ** 2 * var_w + ((m + 1) / m) ** 2 * var_b
             + (2.0 * (n - 1) * (m + 1) / m) * var_wb) / n ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        df = 2.0 * V ** 2 / var_V
        W_df = 2.0 * w ** 2 / var_w

    B_df = m - 1
    R_fixed = (n - 1) / n
    R_random_scale = (m + 1) / (m * n)
    q = 1.0 - alpha / 2.0
    psrf = np.empty((p, 2))
    for i in range(p):
        correction = (df[i] + 3.0) / (df[i] + 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            R_random = R_random_scale * b[i] / w[i]
        psrf[i, 0] = np.sqrt(correction * (R_fixed + R_random))
        if not np.isnan(R_random):
            R_random = R_random * sstats.f.ppf(q, B_df, W_df[i])
        psrf[i, 1] = np.sqrt(correction * (R_fixed + R_random))

    names = list(c.names)
    if mpsrf:
        try:
            L = np.linalg.cholesky(W)
            Winv = np.linalg.inv(L).T @ np.linalg.inv(L)
            lam = np.max(np.linalg.eigvals(Winv @ B).real)
            x = R_fixed + R_random_scale * lam
        except np.linalg.LinAlgError:
            x = np.nan
        psrf = np.vstack([psrf, [x, np.nan]])
        names = names + ["Multivariate"]

    hdr = _header(c) + "\nGelman, Rubin, and Brooks Diagnostic:"
    return ChainSummary(np.round(psrf, 3), names,
                        ["PSRF", f"{100 * q:g}%"], hdr)


# ---------------------------------------------------------------------------
# Geweke
# ---------------------------------------------------------------------------

def gewekediag_vec(x, first: float = 0.1, last: float = 0.5,
                   etype: str = "imse", **kwargs):
    """Z-score + p-value for one series (reference gewekediag.jl:3-17)."""
    if not 0.0 < first < 1.0:
        raise ValueError("first is not in (0, 1)")
    if not 0.0 < last < 1.0:
        raise ValueError("last is not in (0, 1)")
    if first + last > 1.0:
        raise ValueError("first and last proportions overlap")
    x = np.asarray(x, dtype=float).reshape(-1)
    n = len(x)
    x1 = x[: round(first * n)]
    x2 = x[round(n - last * n):]
    z = (x1.mean() - x2.mean()) / np.sqrt(
        mcse(x1, etype, **kwargs) ** 2 + mcse(x2, etype, **kwargs) ** 2)
    p = 1.0 - special.erf(abs(z) / np.sqrt(2.0))
    return round(float(z), 3), round(float(p), 4)


def gewekediag(c: Chains, first: float = 0.1, last: float = 0.5,
               etype: str = "imse", **kwargs) -> ChainSummary:
    _, p, m = c.value.shape
    vals = np.empty((p, 2, m))
    for j in range(p):
        for k in range(m):
            vals[j, :, k] = gewekediag_vec(c.value[:, j, k], first=first,
                                           last=last, etype=etype, **kwargs)
    hdr = (_header(c) + "\nGeweke Diagnostic:\nFirst Window Fraction = "
           f"{first}\nSecond Window Fraction = {last}\n")
    return ChainSummary(vals, c.names, ["Z-score", "p-value"], hdr)


# ---------------------------------------------------------------------------
# Heidelberger & Welch
# ---------------------------------------------------------------------------

def heideldiag_vec(x, alpha: float = 0.05, eps: float = 0.1,
                   etype: str = "imse", start: int = 1, **kwargs):
    """(burnin, stationarity, p-value, mean, halfwidth, passed) for one
    series (reference heideldiag.jl:3-22)."""
    x = np.asarray(x, dtype=float).reshape(-1)
    n = len(x)
    delta = int(0.10 * n)
    y = x[int(n / 2) - 1:]
    S0 = len(y) * mcse(y, etype, **kwargs) ** 2
    i, pvalue, converged, ybar = 1, 1.0, False, np.nan
    while i < n / 2:
        y = x[i - 1:]
        mlen = len(y)
        ybar = y.mean()
        B = np.cumsum(y) - ybar * np.arange(1, mlen + 1)
        Bsq = (B * B) / (mlen * S0)
        I = Bsq.sum() / mlen
        pvalue = 1.0 - pcramer(I)
        converged = pvalue > alpha
        if converged:
            break
        i += delta
    halfwidth = (np.sqrt(2.0) * special.erfinv(1.0 - alpha)
                 * mcse(y, etype, **kwargs))
    passed = halfwidth / abs(ybar) <= eps
    return (i + start - 2, converged, round(float(pvalue), 4), float(ybar),
            float(halfwidth), passed)


def heideldiag(c: Chains, alpha: float = 0.05, eps: float = 0.1,
               etype: str = "imse", **kwargs) -> ChainSummary:
    _, p, m = c.value.shape
    start = int(c.range[0])
    vals = np.empty((p, 6, m))
    for j in range(p):
        for k in range(m):
            vals[j, :, k] = heideldiag_vec(c.value[:, j, k], alpha=alpha,
                                           eps=eps, etype=etype, start=start,
                                           **kwargs)
    hdr = (_header(c) + "\nHeidelberger and Welch Diagnostic:\n"
           f"Target Halfwidth Ratio = {eps}\nAlpha = {alpha}\n")
    return ChainSummary(vals, c.names,
                        ["Burn-in", "Stationarity", "p-value", "Mean",
                         "Halfwidth", "Test"], hdr)


# ---------------------------------------------------------------------------
# Raftery & Lewis
# ---------------------------------------------------------------------------

def rafterydiag_vec(x, q: float = 0.025, r: float = 0.005, s: float = 0.95,
                    eps: float = 0.001, start: int = 1, step: int = 1):
    """(thinning, burnin, total, nmin, dependence factor) via the 2-state
    Markov chain BIC procedure (reference rafterydiag.jl:3-43)."""
    x = np.asarray(x, dtype=float).reshape(-1)
    nx = len(x)
    phi = np.sqrt(2.0) * special.erfinv(s)
    nmin = int(np.ceil(q * (1.0 - q) * (phi / r) ** 2))
    if nmin > nx:
        return (np.nan, np.nan, np.nan, nmin, np.nan)
    dichot = (x <= np.quantile(x, q)).astype(int)
    kthin, bic = 0, 1.0
    while bic >= 0.0:
        kthin += 1
        test = dichot[::kthin]
        ntest = len(test)
        temp = test[: ntest - 2] + 2 * test[1: ntest - 1] + 4 * test[2:]
        tran = np.bincount(temp, minlength=8).reshape(2, 2, 2, order="F")
        g2 = 0.0
        for i1 in range(2):
            for i2 in range(2):
                for i3 in range(2):
                    tt = tran[i1, i2, i3]
                    if tt > 0:
                        fitted = (tran[:, i2, i3].sum() * tran[i1, i2, :].sum()
                                  / tran[:, i2, :].sum())
                        g2 += 2.0 * tt * np.log(tt / fitted)
        bic = g2 - 2.0 * np.log(ntest - 2.0)
    final = np.bincount(test[: ntest - 1] + 2 * test[1:], minlength=4)
    alpha = final[2] / (final[0] + final[2])
    beta = final[1] / (final[1] + final[3])
    kthin *= step
    m = (np.log(eps * (alpha + beta) / max(alpha, beta))
         / np.log(abs(1.0 - alpha - beta)))
    burnin = kthin * np.ceil(m) + start - 1
    n = ((2.0 - alpha - beta) * alpha * beta * phi ** 2
         / (r ** 2 * (alpha + beta) ** 3))
    keep = kthin * np.ceil(n)
    total = burnin + keep
    return (kthin, burnin, total, nmin, total / nmin)


def rafterydiag(c: Chains, q: float = 0.025, r: float = 0.005,
                s: float = 0.95, eps: float = 0.001) -> ChainSummary:
    _, p, m = c.value.shape
    vals = np.empty((p, 5, m))
    for j in range(p):
        for k in range(m):
            vals[j, :, k] = rafterydiag_vec(
                c.value[:, j, k], q=q, r=r, s=s, eps=eps,
                start=int(c.range[0]), step=c.thin)
    hdr = (_header(c) + "\nRaftery and Lewis Diagnostic:\n"
           f"Quantile (q) = {q}\nAccuracy (r) = {r}\nProbability (s) = {s}\n")
    return ChainSummary(vals, c.names,
                        ["Thinning", "Burn-in", "Total", "Nmin",
                         "Dependence Factor"], hdr)
