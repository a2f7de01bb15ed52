"""Warmup adaptation: dual-averaging step size + Welford mass matrix
(diagonal or dense), plus the mass-metric helpers shared by the
samplers.

Counterpart of ``celerite2_tpu/inference/adapt.py``.  Stan-style windowed
schedule: an initial fast window (step size only), doubling slow windows
(mass matrix), and a final fast window.  Pure functions over NamedTuple
states of tensors.  The JAX package unrolls the dense metric's Cholesky
and triangular solve in Python because the TPU has no float64 LAPACK;
here they are ``torch.linalg`` calls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "build_schedule",
    "mass_matvec",
    "mass_kinetic",
    "mass_momentum",
    "chol_small",
]


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(eps0):
    log_eps0 = torch.log(eps0)
    return DualAveragingState(
        log_eps=log_eps0,
        log_eps_avg=torch.zeros_like(log_eps0),
        h_avg=torch.zeros_like(log_eps0),
        mu=math.log(10.0) + log_eps0,
        count=torch.zeros_like(log_eps0),
    )


def da_update(
    state: DualAveragingState,
    accept_prob,
    *,
    target=0.8,
    gamma=0.05,
    t0=10.0,
    kappa=0.75,
):
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014)."""
    count = state.count + 1
    w = 1.0 / (count + t0)
    h_avg = (1.0 - w) * state.h_avg + w * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(
        log_eps=log_eps,
        log_eps_avg=log_eps_avg,
        h_avg=h_avg,
        mu=state.mu,
        count=count,
    )


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim, dtype=torch.float64, *, dense=False, device=None,
                 chains=None):
    """``dense=True`` accumulates the full (dim, dim) second-moment
    matrix for a dense mass metric.  With ``chains`` every field gets a
    leading chain axis: one estimate per chain."""
    lead = () if chains is None else (chains,)
    m2_shape = lead + ((dim, dim) if dense else (dim,))
    return WelfordState(
        mean=torch.zeros(lead + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(m2_shape, dtype=dtype, device=device),
        count=torch.zeros(lead, dtype=dtype, device=device),
    )


def _per_row(count, x):
    """``count`` (one per chain, or one) shaped to broadcast against
    ``x``, which has the chain axes of ``count`` and more."""
    return count.reshape(count.shape + (1,) * (x.dim() - count.dim()))


def welford_update(state: WelfordState, x):
    """One draw ``x`` (dim,), or one per chain (C, dim)."""
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / _per_row(count, delta)
    if state.m2.dim() > state.mean.dim():
        m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, *, regularize=True):
    """Sample variance (diag) or covariance (dense), per chain where the
    state has a chain axis, with Stan's shrinkage towards unit scale for
    short windows."""
    n = _per_row(state.count, state.m2)
    var = state.m2 / torch.clamp(n - 1, min=1)
    if regularize:
        dim = state.mean.shape[-1]
        unit = (
            torch.eye(dim, dtype=var.dtype, device=var.device)
            if state.m2.dim() > state.mean.dim()
            else 1.0
        )
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0)) * unit
    return var


# ------------------------------------------------- mass-metric helpers
#
# ``inv_mass`` is the estimated posterior (co)variance: (dim,) for a
# diagonal metric, (dim, dim) for a dense one, or one per chain, (C, dim)
# and (C, dim, dim), beside momenta ``p (C, dim)``.  A metric is dense when
# it has one axis more than the momenta; a diagonal one may also be shared
# by the chains.  Momenta are drawn from N(0, inv_mass^{-1}).


def chol_small(A):
    """Lower Cholesky of a small SPD matrix."""
    return torch.linalg.cholesky(A)


def _dense(inv_mass, p):
    return inv_mass.dim() == p.dim() + 1


def mass_matvec(inv_mass, p):
    """inv_mass @ p for either metric shape, per chain."""
    if not _dense(inv_mass, p):
        return inv_mass * p
    if p.dim() == 1:
        return inv_mass @ p
    return (inv_mass @ p[..., None])[..., 0]


def mass_kinetic(inv_mass, p):
    """0.5 * p^T inv_mass p, per chain: () for p (dim,), (C,) for
    p (C, dim)."""
    if not _dense(inv_mass, p):
        return 0.5 * torch.sum(inv_mass * p**2, dim=-1)
    if p.dim() == 1:
        return 0.5 * torch.dot(p, inv_mass @ p)
    return 0.5 * torch.sum(p * mass_matvec(inv_mass, p), dim=-1)


def mass_momentum(z, inv_mass):
    """p ~ N(0, inv_mass^{-1}) from standard normals ``z (dim,)`` or
    ``(C, dim)`` (a metric per chain, or a shared diagonal one), or from a
    ``torch.Generator``, which draws one ``(dim,)`` for a metric of one
    chain.

    Dense: with inv_mass = Sigma = L L^T, the momentum covariance is
    Sigma^{-1} = L^{-T} L^{-1}, so p = L^{-T} z.
    """
    if isinstance(z, torch.Generator):
        z = torch.randn(inv_mass.shape[:1], generator=z, dtype=inv_mass.dtype,
                        device=inv_mass.device)
    if _dense(inv_mass, z):
        L = chol_small(inv_mass)
        return torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)[..., 0]
    return z / torch.sqrt(inv_mass)


def build_schedule(num_warmup, *, init_frac=0.15, final_frac=0.1):
    """Per-step flags: (in_slow_window, window_end) as numpy arrays.

    Mirrors Stan's 75/25/... doubling slow windows between an initial
    and final fast (step-size-only) window.
    """
    num_warmup = int(num_warmup)
    init_n = max(1, int(init_frac * num_warmup))
    final_n = max(1, int(final_frac * num_warmup))
    slow_total = max(0, num_warmup - init_n - final_n)

    in_slow = np.zeros(num_warmup, dtype=bool)
    win_end = np.zeros(num_warmup, dtype=bool)
    if slow_total > 0:
        in_slow[init_n : init_n + slow_total] = True
        # doubling windows: 25, 50, 100, ... scaled to fit
        w = max(1, slow_total // 15)
        pos = init_n
        while pos < init_n + slow_total:
            w_eff = min(w, init_n + slow_total - pos)
            # merge a too-small tail into the last window
            if init_n + slow_total - (pos + w_eff) < w * 2:
                w_eff = init_n + slow_total - pos
            pos += w_eff
            win_end[pos - 1] = True
            w *= 2
    return in_slow, win_end
