"""Posterior statistics: summarystats, quantiles, HPD, autocorrelation,
change rate, MCSE/ESS.

Counterpart of reference src/output/stats.jl and src/output/
mcse.jl — same estimators, same defaults, vectorized over parameters with
numpy instead of the reference's per-column ``mapslices`` loops:

- ``summarystats``: Mean, SD, Naive SE, MCSE (batch means by default) and
  ESS (stats.jl:81-94).  The reference computes ESS = min((SD/MCSE)^2,
  niter) on the pooled chains — a formula built for <=4 chains whose
  per-chain cap always binds at 100s-1000s of batched chains, silently
  asserting every kept draw is effective.  Here ESS is the split-chain
  rank-normalized bulk ESS of Vehtari, Gelman, Simpson, Carpenter &
  Buerkner (2021), computed across the chain axis with Geyer's initial
  monotone sequence truncation — honest at any chain count.
- ``ess_rhat``: per-parameter bulk ESS, tail ESS and rank-normalized
  split-R-hat (Vehtari et al. 2021) as a ChainSummary.
- ``mcse``: batch-means ``bm`` (size 100), initial monotone ``imse`` and
  initial positive ``ipse`` sequence estimators (mcse.jl:3-46)
- ``hpd``: smallest-interval empirical HPD (stats.jl:55-77)
- ``autocor``: per-chain autocorrelation at thinning-relative lags
  (stats.jl:3-14); ``changerate`` (stats.jl:19-39); ``cor`` (stats.jl:16-17)
"""

from __future__ import annotations

import numpy as np

from .chains import Chains
from .chainsummary import ChainSummary


def _header(c: Chains) -> str:
    rng = c.range
    return ("Iterations = {}:{}\nThinning interval = {}\nChains = {}\n"
            "Samples per chain = {}\n".format(
                rng[0], rng[-1], c.thin,
                ",".join(str(i) for i in c.chains), c.niter))


def cummean_arr(x: np.ndarray) -> np.ndarray:
    """Running means over the leading axis (reference cummean,
    src/utils.jl:50-60)."""
    x = np.asarray(x, dtype=float)
    n = np.arange(1, x.shape[0] + 1).reshape((-1,) + (1,) * (x.ndim - 1))
    return np.cumsum(x, axis=0) / n


def autocov(x: np.ndarray, lags) -> np.ndarray:
    """Biased (1/n) autocovariances at the given lags over the leading axis;
    x may be (n,) or (n, p)."""
    x = np.asarray(x, dtype=float)
    one_d = x.ndim == 1
    if one_d:
        x = x[:, None]
    n = x.shape[0]
    xc = x - x.mean(0)
    out = np.empty((len(lags), x.shape[1]))
    for i, k in enumerate(lags):
        k = int(k)
        out[i] = (xc[: n - k] * xc[k:]).sum(0) / n if k < n else 0.0
    return out[:, 0] if one_d else out


def mcse(x: np.ndarray, method: str = "imse", **kwargs) -> float:
    x = np.asarray(x, dtype=float).reshape(-1)
    if method == "bm":
        return _mcse_bm(x, **kwargs)
    if method == "imse":
        return _mcse_imse(x)
    if method == "ipse":
        return _mcse_ipse(x)
    raise ValueError(f"unsupported mcse method {method!r}")


def _mcse_bm(x, size: int = 100) -> float:
    n = len(x)
    m = n // size
    if m < 2:
        raise ValueError(
            f"iterations are < {2 * size} and batch size is > {n // 2}")
    mbar = x[: m * size].reshape(m, size).mean(1)
    return float(mbar.std(ddof=1) / np.sqrt(m))


def _paired_gamma(x):
    """Sums of adjacent autocovariance pairs Γ_i = γ_{2i} + γ_{2i+1}."""
    n = len(x)
    m = (n - 2) // 2
    lags = np.arange(0, 2 * m + 2)
    g = autocov(x, lags)
    return g, m


def _mcse_imse(x) -> float:
    g, m = _paired_gamma(x)
    n = len(x)
    Ghat = g[0] + g[1]
    value = -g[0] + 2 * Ghat
    for i in range(1, m + 1):
        Ghat = min(Ghat, g[2 * i] + g[2 * i + 1])
        if Ghat <= 0:
            break
        value += 2 * Ghat
    return float(np.sqrt(value / n))


def _mcse_ipse(x) -> float:
    g, m = _paired_gamma(x)
    n = len(x)
    value = g[0] + 2 * g[1]
    for i in range(1, m + 1):
        Ghat = g[2 * i] + g[2 * i + 1]
        if Ghat <= 0:
            break
        value += 2 * Ghat
    return float(np.sqrt(value / n))


# ---------------------------------------------------------------------------
# Split-chain rank-normalized ESS / R-hat (Vehtari et al. 2021, "Rank-
# normalization, folding, and localization: an improved R-hat for assessing
# convergence of MCMC").  Replaces the reference's pooled (sd/mcse)^2-capped
# ESS (stats.jl:81-94), which is only meaningful at <=4 chains.
# ---------------------------------------------------------------------------

def _split_chains(x: np.ndarray) -> np.ndarray:
    """(n, p, m) -> (n//2, p, 2m): each chain split into halves (detects
    within-chain trend as apparent between-chain variance)."""
    n = x.shape[0] - (x.shape[0] % 2)
    half = n // 2
    return np.concatenate([x[:half], x[half:n]], axis=2)

def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks over all draws of each parameter mapped through the
    normal quantile function (Vehtari et al. 2021, eq. 14): z =
    Phi^-1((r - 3/8) / (S + 1/4))."""
    from scipy.special import ndtri
    from scipy.stats import rankdata
    n, p, m = x.shape
    flat = x.transpose(1, 0, 2).reshape(p, n * m)
    r = rankdata(flat, method="average", axis=1)
    z = ndtri((r - 0.375) / (n * m + 0.25))
    return z.reshape(p, n, m).transpose(1, 0, 2)

def _chain_autocov_fft(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) per-chain autocovariances at all lags via FFT.
    x: (n, p, m) -> (n, p, m)."""
    n = x.shape[0]
    xc = x - x.mean(0)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n]
    return acov.real / n

def _ess_rhat_core(x: np.ndarray):
    """ESS and split-R-hat of (already rank-normalized, already split)
    chains x: (n, p, m).  Returns (ess, rhat) arrays of shape (p,)."""
    n, p, m = x.shape
    if n < 4 or m < 2:
        return np.full(p, np.nan), np.full(p, np.nan)
    chain_mean = x.mean(0)                       # (p, m)
    chain_var = x.var(0, ddof=1)                 # (p, m)
    W = chain_var.mean(1)                        # (p,)
    B_over_n = chain_mean.var(1, ddof=1)         # (p,)
    with np.errstate(divide="ignore", invalid="ignore"):
        var_plus = W * (n - 1) / n + B_over_n
        rhat = np.sqrt(var_plus / W)
        acov = _chain_autocov_fft(x).mean(2)     # (n, p) mean over chains
        rho = 1.0 - (W[None, :] - acov) / var_plus[None, :]
    rho[0] = 1.0
    # Geyer (1992) initial monotone positive sequence on paired sums
    kmax = n // 2
    pairs = rho[0:2 * kmax:2] + rho[1:2 * kmax:2]          # (kmax, p)
    pos = np.cumprod(pairs > 0, axis=0).astype(bool)        # truncate at <=0
    pairs = np.where(pos, pairs, 0.0)
    pairs = np.minimum.accumulate(pairs, axis=0)            # monotone decay
    pairs = np.maximum(pairs, 0.0)
    tau = -1.0 + 2.0 * pairs.sum(0)
    nm = n * m
    # antithetic-chain guard (ESS can't exceed nm * log10(nm); arviz rule)
    tau = np.maximum(tau, 1.0 / np.log10(max(nm, 10)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ess = np.where(np.isfinite(var_plus) & (var_plus > 0),
                       nm / tau, np.nan)
        rhat = np.where(W > 0, rhat, np.nan)
    return ess, rhat

def ess_bulk(value: np.ndarray) -> np.ndarray:
    """Split-chain rank-normalized bulk ESS per parameter.
    value: (n_draws, n_params, n_chains) -> (n_params,)."""
    x = _split_chains(np.asarray(value, dtype=float))
    return _ess_rhat_core(_rank_normalize(x))[0]

def ess_tail(value: np.ndarray, prob: float = 0.05) -> np.ndarray:
    """Tail ESS: min over the ESS of the 5%/95% quantile indicator chains
    (Vehtari et al. 2021 sec. 4.3)."""
    x = _split_chains(np.asarray(value, dtype=float))
    n, p, m = x.shape
    out = np.full((2, p), np.nan)
    for i, q in enumerate((prob, 1.0 - prob)):
        qv = np.quantile(x.transpose(1, 0, 2).reshape(p, -1), q, axis=1)
        ind = (x <= qv[None, :, None]).astype(float)
        out[i] = _ess_rhat_core(_rank_normalize(ind))[0]
    return out.min(0)

def rhat_rank(value: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat: max of the bulk R-hat and the folded
    (tail-sensitive) R-hat (Vehtari et al. 2021 eq. 13-15)."""
    x = _split_chains(np.asarray(value, dtype=float))
    r_bulk = _ess_rhat_core(_rank_normalize(x))[1]
    p = x.shape[1]
    med = np.median(x.transpose(1, 0, 2).reshape(p, -1), axis=1)
    folded = np.abs(x - med[None, :, None])
    r_tail = _ess_rhat_core(_rank_normalize(folded))[1]
    return np.fmax(r_bulk, r_tail)

def ess_rhat(c: Chains) -> ChainSummary:
    """Per-parameter bulk ESS, tail ESS and rank-normalized split-R-hat
    (Vehtari et al. 2021) computed across the chain axis."""
    v = np.asarray(c.value, dtype=float)
    vals = np.column_stack([ess_bulk(v), ess_tail(v), rhat_rank(v)])
    return ChainSummary(vals, c.names, ["ESS bulk", "ESS tail", "R-hat"],
                        _header(c))

def summarystats(c: Chains, etype: str = "bm", **kwargs) -> ChainSummary:
    """Empirical posterior estimates table (reference stats.jl:81-94).

    Mean/SD/Naive SE/MCSE follow the reference estimators on the pooled
    chains; ESS is the split-chain rank-normalized bulk ESS across the
    chain axis (see module docstring for why the reference's capped pooled
    formula is replaced).  The estimators run in float64: numpy sums a
    column of a float32 matrix one term after another in float32, and over
    a million draws (1024 chains x 1000) that moves a mean by a sixth of
    a posterior standard deviation (the JAX package's summarystats does
    so)."""
    comb = np.asarray(c.combine(), dtype=np.float64)   # (niter*nchains, p)
    n = comb.shape[0]
    mean = comb.mean(0)
    sd = comb.std(0, ddof=1)
    naive = sd / np.sqrt(n)
    mc = np.array([mcse(comb[:, j], etype, **kwargs)
                   for j in range(comb.shape[1])])
    ess = ess_bulk(np.asarray(c.value, dtype=float))
    vals = np.column_stack([mean, sd, naive, mc, ess])
    return ChainSummary(vals, c.names,
                        ["Mean", "SD", "Naive SE", "MCSE", "ESS"], _header(c))


def quantile(c: Chains, q=(0.025, 0.25, 0.5, 0.75, 0.975)) -> ChainSummary:
    comb = c.combine()
    vals = np.quantile(comb, list(q), axis=0).T
    labels = [f"{100 * p:g}%" for p in q]
    return ChainSummary(vals, c.names, labels, _header(c))


def hpd(c: Chains, alpha: float = 0.05) -> ChainSummary:
    """Per-parameter smallest-width empirical interval containing
    (1-alpha) of the draws (reference stats.jl:55-77)."""
    comb = c.combine()
    n = comb.shape[0]
    m = max(1, int(np.ceil(alpha * n)))
    y = np.sort(comb, axis=0)
    a = y[:m]                      # candidate lower bounds
    b = y[n - m:]                  # candidate upper bounds
    i = np.argmin(b - a, axis=0)
    cols = np.arange(comb.shape[1])
    vals = np.column_stack([a[i, cols], b[i, cols]])
    pct = f"{100 * (1 - alpha):g}"
    return ChainSummary(vals, c.names, [f"{pct}% Lower", f"{pct}% Upper"],
                        _header(c))


def autocor(c: Chains, lags=(1, 5, 10, 50), relative: bool = True) -> ChainSummary:
    lags = np.asarray(lags, dtype=int)
    if relative:
        lags = lags * c.thin
    elif np.any(lags % c.thin != 0):
        raise ValueError("lags do not correspond to thinning interval")
    labels = [f"Lag {k}" for k in lags]
    out = np.empty((c.nparams, len(lags), c.nchains))
    rel = lags // c.thin
    for k in range(c.nchains):
        g = autocov(c.value[:, :, k], [0] + list(rel))
        out[:, :, k] = (g[1:] / g[0]).T
    return ChainSummary(out, c.names, labels, _header(c))


def cor(c: Chains) -> ChainSummary:
    comb = c.combine()
    return ChainSummary(np.corrcoef(comb, rowvar=False), c.names, c.names,
                        _header(c))


def changerate(c: Chains) -> ChainSummary:
    """Per-parameter (and joint 'Multivariate') state-change frequency — the
    acceptance-rate proxy (reference stats.jl:19-39)."""
    v = c.value
    n, p, m = v.shape
    d = v[1:] != v[:-1]                       # (n-1, p, m)
    r = d.sum(axis=(0, 2)) / (m * (n - 1))
    r_mv = d.any(axis=1).sum() / (m * (n - 1))
    vals = np.round(np.concatenate([r, [r_mv]]), 3)
    return ChainSummary(vals[:, None], c.names + ["Multivariate"],
                        ["Change Rate"], _header(c))


def describe(c: Chains, q=(0.025, 0.25, 0.5, 0.75, 0.975), etype: str = "bm",
             stream=None, **kwargs):
    """Print Empirical Posterior Estimates + Quantiles (reference
    stats.jl:41-52).  Returns (summarystats, quantiles)."""
    import sys
    stream = stream or sys.stdout
    s = summarystats(c, etype=etype, **kwargs)
    qs = quantile(c, q=q)
    print(s.header, file=stream)
    print("Empirical Posterior Estimates:", file=stream)
    print(repr(ChainSummary(s.value, s.rownames, s.colnames)), file=stream)
    print("Quantiles:", file=stream)
    print(repr(ChainSummary(qs.value, qs.rownames, qs.colnames)), file=stream)
    return s, qs
