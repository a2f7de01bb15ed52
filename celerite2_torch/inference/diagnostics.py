"""Sampling diagnostics: split R-hat and bulk effective sample size.

Counterpart of ``celerite2_tpu/inference/diagnostics.py``.  Samples are
``(C, N, dim)``: chains, draws, parameters.  The ESS runs in float64
whatever the input's type.
"""

from __future__ import annotations

import math

import torch

__all__ = ["split_rhat", "effective_sample_size", "summary"]


def _split_chains(x):
    """(C, N, ...) -> (2C, N//2, ...)"""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half : 2 * half]], dim=0)


def split_rhat(samples):
    """Gelman-Rubin split R-hat.  ``samples (C, N, dim)`` -> ``(dim,)``."""
    x = _split_chains(samples)
    N = x.shape[1]
    chain_mean = x.mean(dim=1)  # (2C, dim)
    chain_var = x.var(dim=1, correction=1)  # (2C, dim)
    W = chain_var.mean(dim=0)
    B = N * chain_mean.var(dim=0, correction=1)
    var_plus = (N - 1) / N * W + B / N
    return torch.sqrt(var_plus / W)


def _autocov(x, max_lag):
    """Per-chain autocovariance up to max_lag via FFT. x (C, N, dim)."""
    N = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * N, dim=1)
    acov = torch.fft.irfft(f * f.conj(), n=2 * N, dim=1)[:, : max_lag + 1]
    return acov / N


def effective_sample_size(samples, *, max_lag=None):
    """Bulk ESS via Geyer's initial monotone sequence.
    ``samples (C, N, dim)`` -> ``(dim,)``, float64."""
    x = _split_chains(torch.as_tensor(samples).to(torch.float64))
    C, N, dim = x.shape
    if max_lag is None:
        max_lag = min(N - 1, 1000)

    acov = _autocov(x, max_lag)  # (C, L+1, dim)
    chain_var = acov[:, 0]  # biased (ddof=0) per-chain variance
    mean_var = (chain_var * N / (N - 1)).mean(dim=0)
    var_plus = mean_var * (N - 1) / N + x.mean(dim=1).var(dim=0, correction=1)

    rho = 1.0 - (mean_var - acov.mean(dim=0)) / var_plus  # (L+1, dim)

    # Geyer: sum consecutive pairs, keep while positive and decreasing
    L = rho.shape[0] - (rho.shape[0] % 2)
    pair = rho[:L].reshape(L // 2, 2, dim).sum(dim=1)  # (L/2, dim)
    # prefix-AND to find the initial positive sequence
    keep = torch.cumprod((pair > 0).to(torch.int32), dim=0).bool()
    pair = torch.where(keep, pair, torch.zeros_like(pair))
    # enforce monotone decrease
    pair = torch.cummin(pair, dim=0).values
    tau = -1.0 + 2.0 * pair.sum(dim=0)
    tau = torch.clamp(tau, min=1.0 / math.log10(C * N))
    return C * N / tau


def summary(samples):
    """Posterior summary dict: mean, sd, 5/95%, ESS, R-hat."""
    s = torch.as_tensor(samples)
    flat = s.reshape(-1, s.shape[-1])
    return {
        "mean": flat.mean(dim=0),
        "sd": flat.std(dim=0, correction=0),
        "q05": torch.quantile(flat, 0.05, dim=0, interpolation="linear"),
        "q95": torch.quantile(flat, 0.95, dim=0, interpolation="linear"),
        "ess": effective_sample_size(s),
        "rhat": split_rhat(s),
    }
