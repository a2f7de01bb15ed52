"""The sequential semiseparable recursions: the LDL^T factor and the four
sweeps (two solves, two matmuls), row by row.

Counterpart of the forward half of ``celerite2_tpu/ops/scan.py``
(``transport``, ``transport_up``, ``factor_scan``, ``_sweep`` and the four
named sweeps).  Every argument carries a leading chain axis: ``t (C, N)``,
``c (C, J)``, ``a (C, N)``, ``U, V, W (C, N, J)``, ``Y (C, N, K)``; the C
systems are independent.  The caches come back too (``S_half (C, N, J,
J)``, ``F (C, N, J, K)``) in the JAX package's conventions, so each can be
held against its scan tier.

Each recursion exists twice:

* ``factor_fwd_plain`` / ``sweep_fwd_plain``: a plain PyTorch loop over
  the N rows.  The CPU route, and what the kernels are held against.
* ``factor_fwd`` / ``sweep_fwd``: the CUDA kernel of
  ``csrc/general_ops.cu`` for CUDA tensors, the plain loop for CPU
  tensors.

So does the diagonal-affine prefix ``F_m = phi_m F_prev + G_m`` that the
rectangular products of ``ops/api.py`` accumulate with (the JAX package's
``assoc._diag_affine_scan``, which its prefix engine runs on a TPU):
``affine_prefix_plain`` is a doubling in plain PyTorch, ``affine_prefix``
the blocked CUDA kernel for CUDA tensors.

Both take the transport ``p (C, N, J)`` where the JAX functions take
``(t, c)``; ``factor_scan``, ``_sweep`` and the named sweeps are the JAX
signatures on top of the plain loops.  The adjoint recursions
(``factor_rev_scan``, ``sweep_rev_scan``) are not ported yet (ROADMAP.md
items B9, B10).
"""

from __future__ import annotations

import torch

from celerite2_torch.ops import _build

__all__ = [
    "transport",
    "transport_up",
    "factor_fwd",
    "factor_fwd_plain",
    "sweep_fwd",
    "sweep_fwd_plain",
    "affine_prefix",
    "affine_prefix_plain",
    "factor_scan",
    "solve_lower_scan",
    "solve_upper_scan",
    "matmul_lower_scan",
    "matmul_upper_scan",
]


def transport(t, c):
    """``phi (C, N, J)``: ``phi[n] = exp(-c (t[n] - t[n-1]))``, ``phi[0] =
    0`` (nothing propagates into the first row)."""
    phi = torch.exp(-c[..., None, :] * torch.diff(t, dim=-1)[..., None])
    return torch.cat([torch.zeros_like(c)[..., None, :], phi], -2)


def transport_up(t, c):
    """``phi_up (C, N, J)``: ``phi_up[n] = exp(-c (t[n+1] - t[n]))``,
    ``phi_up[N-1] = 0``."""
    phi = torch.exp(-c[..., None, :] * torch.diff(t, dim=-1)[..., None])
    return torch.cat([phi, torch.zeros_like(c)[..., None, :]], -2)


def _safe(x):
    """Guarded divisor: a non-positive pivot divides by 1 (quiet
    semantics: finite garbage instead of NaN)."""
    return torch.where(x > 0, x, torch.ones_like(x))


# ============================================================== factor


def factor_fwd_plain(p, a, U, V):
    """Plain version of the factor kernel: the LDL^T recursion

        S <- p (S + d w w^T) p,  d_n = a_n - u^T S u,  w_n = (v - S u) / d_n

    over the rows of every chain.  Returns ``d (C, N)``, ``W (C, N, J)``
    and the cache ``S_half (C, N, J, J)``, the one-sided transported carry
    ``diag(p_n) (S_{n-1} + d_{n-1} w_{n-1} w_{n-1}^T)``."""
    C, N, J = U.shape
    S = p.new_zeros(C, J, J)
    d_prev = p.new_zeros(C)
    w_prev = p.new_zeros(C, J)
    ds, ws, Ss = [], [], []
    for p_n, a_n, u_n, v_n in zip(p.unbind(1), a.unbind(1), U.unbind(1), V.unbind(1)):
        S = S + d_prev[:, None, None] * w_prev[:, :, None] * w_prev[:, None, :]
        S_half = p_n[:, :, None] * S
        S = S_half * p_n[:, None, :]
        tmp = (S * u_n[:, None, :]).sum(-1)
        d_prev = a_n - (u_n * tmp).sum(-1)
        w_prev = (v_n - tmp) / _safe(d_prev)[:, None]
        ds.append(d_prev)
        ws.append(w_prev)
        Ss.append(S_half)
    return torch.stack(ds, 1), torch.stack(ws, 1), torch.stack(Ss, 1)


def factor_fwd(p, a, U, V, *, want_cache=False):
    """The factor recursion: the CUDA kernel for CUDA tensors, the plain
    loop on the CPU.  Returns ``(d, W, S_half)``; ``S_half`` is None
    unless ``want_cache``."""
    if p.device.type == "cpu":
        d, W, S_half = factor_fwd_plain(p, a, U, V)
        return d, W, (S_half if want_cache else None)
    return _build.factor_fwd_cuda(p, a, U, V, want_cache)


def factor_scan(t, c, a, U, V):
    """LDL^T factorization of C celerite systems, ``K = L diag(d) L^T``
    with ``L = I + tril_strict(U W^T (x) transport)``; returns ``(d, W,
    S_half)`` (``celerite2_tpu.ops.scan.factor_scan`` per chain)."""
    return factor_fwd_plain(transport(t, c), a, U, V)


# ============================================================== sweeps


def sweep_fwd_plain(p, A, B, Y, *, is_solve, upper):
    """Plain version of the sweep kernel.  Lower (rows ascending):

        F_n = p_n (F_{n-1} + b_{n-1} r_{n-1}^T),  proj_n = a_n^T F_n

    with ``z_n = y_n - proj_n``, ``r = z`` for a solve and ``z_n =
    proj_n``, ``r = y`` for a matmul.  Upper sweeps walk the rows
    descending, with ``p`` the upward transport.  Returns ``Z (C, N, K)``
    and the cache ``F (C, N, J, K)``, the carry before its transport."""
    C, N, J = A.shape
    K = Y.shape[-1]
    F = Y.new_zeros(C, J, K)
    b_prev = A.new_zeros(C, J)
    r_prev = Y.new_zeros(C, K)
    Zs, Fs = [None] * N, [None] * N
    p_rows, a_rows, b_rows, y_rows = (x.unbind(1) for x in (p, A, B, Y))
    for n in range(N - 1, -1, -1) if upper else range(N):
        F = F + b_prev[:, :, None] * r_prev[:, None, :]
        Fs[n] = F
        F = p_rows[n][:, :, None] * F
        proj = (F * a_rows[n][:, :, None]).sum(1)
        Zs[n] = y_rows[n] - proj if is_solve else proj
        r_prev = Zs[n] if is_solve else y_rows[n]
        b_prev = b_rows[n]
    return torch.stack(Zs, 1), torch.stack(Fs, 1)


def sweep_fwd(p, A, B, Y, *, is_solve, upper, want_cache=False):
    """The sweep recursion: the CUDA kernel for CUDA tensors, the plain
    loop on the CPU.  Returns ``(Z, F)``; ``F`` is None unless
    ``want_cache``."""
    if p.device.type == "cpu":
        Z, F = sweep_fwd_plain(p, A, B, Y, is_solve=is_solve, upper=upper)
        return Z, (F if want_cache else None)
    return _build.sweep_fwd_cuda(p, A, B, Y, is_solve, upper, want_cache)


def _sweep(t, c, A, B, Y, *, is_solve, upper):
    """``celerite2_tpu.ops.scan._sweep`` per chain, on the plain loop."""
    p = transport_up(t, c) if upper else transport(t, c)
    return sweep_fwd_plain(p, A, B, Y, is_solve=is_solve, upper=upper)


def solve_lower_scan(t, c, U, W, Y):
    """Z = L^{-1} Y with L = I + tril_strict(U W^T (x) transport)."""
    return _sweep(t, c, U, W, Y, is_solve=True, upper=False)


def solve_upper_scan(t, c, U, W, Y):
    """Z = L^{-T} Y."""
    return _sweep(t, c, W, U, Y, is_solve=True, upper=True)


def matmul_lower_scan(t, c, U, V, Y):
    """Z = tril_strict(U V^T (x) transport) @ Y (the increment only)."""
    return _sweep(t, c, U, V, Y, is_solve=False, upper=False)


def matmul_upper_scan(t, c, U, V, Y):
    """Z = triu_strict(V U^T (x) transport) @ Y (the increment only)."""
    return _sweep(t, c, V, U, Y, is_solve=False, upper=True)


# ======================================================= affine prefix


def affine_prefix_plain(phi, G, *, reverse=False):
    """Plain version of the affine prefix kernel: the inclusive ``F_m =
    phi_m F_prev + G_m`` over the rows of ``G (C, M, J, K)``, with ``phi (C,
    M, J)``; ``F_prev`` is ``F_{m-1}``, or ``F_{m+1}`` with ``reverse``.

    A Hillis-Steele doubling of the diagonal-affine combine ``(alpha_2
    alpha_1, alpha_2 b_1 + b_2)`` over ceil(log2 M) levels."""
    alpha, b = phi[..., None], G
    if reverse:
        alpha, b = alpha.flip(-3), b.flip(-3)
    M = b.shape[-3]
    k = 1
    while k < M:
        b = torch.cat(
            [b[..., :k, :, :],
             alpha[..., k:, :, :] * b[..., :-k, :, :] + b[..., k:, :, :]], -3
        )
        alpha = torch.cat(
            [alpha[..., :k, :, :],
             alpha[..., k:, :, :] * alpha[..., :-k, :, :]], -3
        )
        k *= 2
    return b.flip(-3) if reverse else b


def affine_prefix(phi, G, *, reverse=False):
    """The affine prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU."""
    if G.device.type == "cpu":
        return affine_prefix_plain(phi, G, reverse=reverse)
    return _build.affine_prefix_cuda(phi, G, reverse)
