"""Split-chain rank-normalized bulk ESS (Vehtari et al. 2021).

Frozen copy of ``mamba_tpu_torch/output/stats.py`` (``_split_chains``,
``_rank_normalize``, ``_chain_autocov_fft``, ``_ess_rhat_core``,
``ess_bulk``, ``rhat_rank``) at commit fc13fd826c36831480dadd26fb8e0f34af6cabfa.
Draws are ``(n_draws, n_params, n_chains)``.
"""

from __future__ import annotations

import numpy as np


def split_chains(x: np.ndarray) -> np.ndarray:
    """(n, p, m) -> (n//2, p, 2m): each chain split into halves."""
    n = x.shape[0] - (x.shape[0] % 2)
    half = n // 2
    return np.concatenate([x[:half], x[half:n]], axis=2)


def rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks over all draws of each parameter through the normal
    quantile function: z = Phi^-1((r - 3/8) / (S + 1/4))."""
    from scipy.special import ndtri
    from scipy.stats import rankdata
    n, p, m = x.shape
    flat = x.transpose(1, 0, 2).reshape(p, n * m)
    r = rankdata(flat, method="average", axis=1)
    z = ndtri((r - 0.375) / (n * m + 0.25))
    return z.reshape(p, n, m).transpose(1, 0, 2)


def chain_autocov_fft(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) per-chain autocovariances at all lags via FFT."""
    n = x.shape[0]
    xc = x - x.mean(0)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n]
    return acov.real / n


def ess_rhat_core(x: np.ndarray):
    """ESS and split-R-hat of rank-normalized, split chains (n, p, m)."""
    n, p, m = x.shape
    if n < 4 or m < 2:
        return np.full(p, np.nan), np.full(p, np.nan)
    chain_mean = x.mean(0)
    chain_var = x.var(0, ddof=1)
    W = chain_var.mean(1)
    B_over_n = chain_mean.var(1, ddof=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        var_plus = W * (n - 1) / n + B_over_n
        rhat = np.sqrt(var_plus / W)
        acov = chain_autocov_fft(x).mean(2)
        rho = 1.0 - (W[None, :] - acov) / var_plus[None, :]
    rho[0] = 1.0
    # Geyer (1992) initial monotone positive sequence on paired sums
    kmax = n // 2
    pairs = rho[0:2 * kmax:2] + rho[1:2 * kmax:2]
    pos = np.cumprod(pairs > 0, axis=0).astype(bool)
    pairs = np.where(pos, pairs, 0.0)
    pairs = np.minimum.accumulate(pairs, axis=0)
    pairs = np.maximum(pairs, 0.0)
    tau = -1.0 + 2.0 * pairs.sum(0)
    nm = n * m
    tau = np.maximum(tau, 1.0 / np.log10(max(nm, 10)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ess = np.where(np.isfinite(var_plus) & (var_plus > 0),
                       nm / tau, np.nan)
        rhat = np.where(W > 0, rhat, np.nan)
    return ess, rhat


def ess_bulk(value: np.ndarray) -> np.ndarray:
    """Bulk ESS per parameter of ``value`` (n_draws, n_params, n_chains)."""
    x = split_chains(np.asarray(value, dtype=float))
    return ess_rhat_core(rank_normalize(x))[0]


def rhat_rank(value: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat: the larger of the bulk and the folded
    R-hat, per parameter."""
    x = split_chains(np.asarray(value, dtype=float))
    r_bulk = ess_rhat_core(rank_normalize(x))[1]
    p = x.shape[1]
    med = np.median(x.transpose(1, 0, 2).reshape(p, -1), axis=1)
    folded = np.abs(x - med[None, :, None])
    r_tail = ess_rhat_core(rank_normalize(folded))[1]
    return np.fmax(r_bulk, r_tail)
