"""The sequential semiseparable recursions, row by row: the LDL^T factor,
the four sweeps (two solves, two matmuls), the factor fused with the lower
solve, and the adjoints of the factor and of the sweeps.

Counterpart of ``celerite2_tpu/ops/scan.py`` (``transport``,
``transport_up``, ``factor_scan``, ``factor_solve_scan``,
``factor_rev_scan``, ``_sweep``, the four named sweeps and
``sweep_rev_scan``).  Every argument carries a leading chain axis: ``t (C, N)``,
``c (C, J)``, ``a (C, N)``, ``U, V, W (C, N, J)``, ``Y (C, N, K)``; the C
systems are independent.  The caches come back too (``S_half (C, N, J,
J)``, ``F (C, N, J, K)``) in the JAX package's conventions, so each can be
held against its scan tier.

Each recursion exists twice:

* ``factor_fwd_plain``, ``sweep_fwd_plain``, ``factor_bwd_plain``,
  ``sweep_bwd_plain``: a plain PyTorch loop over the N rows.  The CPU
  route, and what the kernels are held against.
* ``factor_fwd``, ``sweep_fwd``, ``factor_bwd``, ``sweep_bwd``: the CUDA
  kernel of ``csrc/general_ops.cu`` for CUDA tensors, the plain loop for
  CPU tensors.  ``factor_solve`` is the factor and the lower solve: one
  fused plain loop on the CPU, the two kernels on the card.

So does the diagonal-affine prefix ``F_m = phi_m F_prev + G_m`` that the
rectangular products of ``ops/api.py`` accumulate with (the JAX package's
``assoc._diag_affine_scan``, which its prefix engine runs on a TPU):
``affine_prefix_plain`` is a doubling in plain PyTorch, ``affine_prefix``
the single-pass CUDA kernel of ``csrc/assoc_prefix.cu`` for CUDA tensors,
``affine_prefix_tiled`` that kernel's order in plain PyTorch (for the
tests on the CPU).

The recursions take the transport ``p (C, N, J)`` where the JAX functions
take ``(t, c)``; the ``*_scan`` functions are the JAX signatures on top of
the plain loops.  The adjoints return per-row cotangents, among them ``bp``
of the transport (of ``log p``, strictly: ``bp = p * dL/dp``);
:func:`time_cotangents` turns it into the ``bt`` and ``bc`` of the JAX
package's adjoints.
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
    "affine_prefix_tiled",
    "factor_bwd",
    "factor_bwd_plain",
    "sweep_bwd",
    "sweep_bwd_plain",
    "factor_solve",
    "factor_solve_plain",
    "time_cotangents",
    "factor_scan",
    "factor_solve_scan",
    "factor_rev_scan",
    "solve_lower_scan",
    "solve_upper_scan",
    "matmul_lower_scan",
    "matmul_upper_scan",
    "sweep_rev_scan",
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


def time_cotangents(t, c, bp, *, upper=False):
    """``(bt (C, N), bc (C, J))`` from the cotangent ``bp (C, N, J)`` of the
    transport's logarithm ``log p_n = -c dt_n``, where ``dt_n = t[n] -
    t[n-1]`` (``transport``) or, with ``upper``, ``t[n+1] - t[n]``
    (``transport_up``).  The row where nothing enters has ``bp = 0``."""
    ft = (bp * c[..., None, :]).sum(-1)
    dt = torch.diff(t, dim=-1)[..., None]
    zero = torch.zeros_like(ft[..., :1])
    if upper:
        bc = -(bp[..., :-1, :] * dt).sum(-2)
        bt = ft - torch.cat([zero, ft[..., :-1]], -1)
    else:
        bc = -(bp[..., 1:, :] * dt).sum(-2)
        bt = torch.cat([ft[..., 1:], zero], -1) - ft
    return bt, bc


def factor_bwd_plain(p, d, U, W, S_half, bd, bW):
    """Plain version of the factor adjoint kernel: the reverse of
    :func:`factor_fwd_plain` over the rows, descending, with the carried
    adjoint ``bS (C, J, J)`` of the carry and the deferrals ``dba``, ``dbv``
    that row n hands to row n - 1 (``celerite2_tpu.ops.scan.factor_rev_scan``
    per chain, the boundary row 0 outside the loop):

        ba = bd_n + dba;  bv = bW_n / d_n + dbv;  ba -= w_n . bv
        bU_n = -(S_half_n diag(p_n)) (bv + 2 ba u_n)
        bS -= u_n (bv + ba u_n)^T
        bp_n = diag(bS S_half_n + S_half_n^T bS) p_n
        bS <- diag(p_n) bS diag(p_n)
        dba = w_{n-1}^T bS w_{n-1};  dbv = (bS + bS^T) w_{n-1}

    A non-positive pivot divides by 1, as in the forward.  Returns ``ba (C,
    N)``, ``bU``, ``bV`` and ``bp (C, N, J)``; ``bU`` and ``bp`` are zero at
    row 0."""
    C, N, J = U.shape
    bS = U.new_zeros(C, J, J)
    dba = U.new_zeros(C)
    dbv = U.new_zeros(C, J)
    bv_base = bW / _safe(d)[..., None]
    ba_r, bU_r, bV_r = [None] * N, [None] * N, [None] * N
    bp_r = [U.new_zeros(C, J)] * N
    for n in range(N - 1, 0, -1):
        p_n, u_n, w_n, Sh = p[:, n], U[:, n], W[:, n], S_half[:, n]
        bv = bv_base[:, n] + dbv
        ba = bd[:, n] + dba - (w_n * bv).sum(-1)
        g = bv + 2.0 * ba[:, None] * u_n
        bU_r[n] = -(Sh * p_n[:, None, :] * g[:, None, :]).sum(-1)
        bS = bS - u_n[:, :, None] * (bv + ba[:, None] * u_n)[:, None, :]
        bp_r[n] = ((bS.mT * Sh).sum(-2) + (Sh * bS).sum(-2)) * p_n
        bS = p_n[:, :, None] * bS * p_n[:, None, :]
        w_prev = W[:, n - 1]
        dba = (w_prev[:, :, None] * bS * w_prev[:, None, :]).sum((-2, -1))
        dbv = ((bS + bS.mT) * w_prev[:, None, :]).sum(-1)
        ba_r[n], bV_r[n] = ba, bv
    bV_r[0] = bv_base[:, 0] + dbv
    ba_r[0] = bd[:, 0] + dba - (W[:, 0] * bV_r[0]).sum(-1)
    bU_r[0] = U.new_zeros(C, J)
    return (torch.stack(ba_r, 1), torch.stack(bU_r, 1), torch.stack(bV_r, 1),
            torch.stack(bp_r, 1))


def factor_bwd(p, d, U, W, S_half, bd, bW):
    """The factor adjoint: the CUDA kernel for CUDA tensors, the plain loop
    on the CPU.  Returns ``(ba, bU, bV, bp)``."""
    if p.device.type == "cpu":
        return factor_bwd_plain(p, d, U, W, S_half, bd, bW)
    return _build.factor_bwd_cuda(p, d, U, W, S_half, bd, bW)


def factor_rev_scan(t, c, a, U, V, d, W, S, bd, bW):
    """Adjoint of :func:`factor_scan`: ``(bt, bc, ba, bU, bV)``
    (``celerite2_tpu.ops.scan.factor_rev_scan`` per chain)."""
    ba, bU, bV, bp = factor_bwd_plain(transport(t, c), d, U, W, S, bd, bW)
    bt, bc = time_cotangents(t, c, bp)
    return bt, bc, ba, bU, bV


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


def sweep_bwd_plain(p, A, B, R, F, bZ, *, is_solve, upper):
    """Plain version of the sweep adjoint kernel: the reverse of
    :func:`sweep_fwd_plain`, walking the rows in the order opposite to the
    forward's (descending for a lower sweep, ascending for an upper one).
    ``R (C, N, K)`` holds the rows that fed the forward carry: ``Z`` for a
    solve, ``Y`` for a matmul; ``F`` is the forward's cache.

    The carry ``bF (C, J, K)`` is the cotangent of the transported carry of
    the row walked before.  Per row n, what the rows walked later left for
    it comes first, then the row's own step (``s`` = -1 for a solve, +1 for
    a matmul):

        bB_n = bF r_n;  dbR = bF^T b_n;  bz = bZ_n (+ dbR for a solve)
        bA_n = s diag(p_n) F_n bz;  M = bF + s a_n bz^T
        bp_n = p_n sum_k (F_n o M);  bF = diag(p_n) M

    with ``bY_n = bz`` for a solve and ``dbR`` for a matmul
    (``celerite2_tpu.ops.scan.sweep_rev_scan`` per chain).  Returns ``bA,
    bB, bp (C, N, J)`` and ``bY (C, N, K)``."""
    C, N, J = A.shape
    sign = -1.0 if is_solve else 1.0
    bF = bZ.new_zeros(C, J, bZ.shape[-1])
    bA, bB, bp, bY = ([None] * N for _ in range(4))
    for n in range(N) if upper else range(N - 1, -1, -1):
        bB[n] = (bF * R[:, n, None, :]).sum(-1)
        dbR = (bF * B[:, n, :, None]).sum(-2)
        bz = bZ[:, n] + dbR if is_solve else bZ[:, n]
        bY[n] = bz if is_solve else dbR
        p_n, F_n = p[:, n], F[:, n]
        bA[n] = sign * p_n * (F_n * bz[:, None, :]).sum(-1)
        M = bF + sign * A[:, n, :, None] * bz[:, None, :]
        bp[n] = p_n * (F_n * M).sum(-1)
        bF = p_n[:, :, None] * M
    return tuple(torch.stack(x, 1) for x in (bA, bB, bp, bY))


def sweep_bwd(p, A, B, R, F, bZ, *, is_solve, upper):
    """The sweep adjoint: the CUDA kernel for CUDA tensors, the plain loop
    on the CPU.  Returns ``(bA, bB, bp, bY)``."""
    if p.device.type == "cpu":
        return sweep_bwd_plain(p, A, B, R, F, bZ, is_solve=is_solve, upper=upper)
    return _build.sweep_bwd_cuda(p, A, B, R, F, bZ, is_solve, upper)


def sweep_rev_scan(t, c, A, B, Y, Z, F, bZ, *, is_solve, upper):
    """Adjoint of :func:`_sweep`: ``(bt, bc, bA, bB, bY)``
    (``celerite2_tpu.ops.scan.sweep_rev_scan`` per chain)."""
    p = transport_up(t, c) if upper else transport(t, c)
    bA, bB, bp, bY = sweep_bwd_plain(
        p, A, B, Z if is_solve else Y, F, bZ, is_solve=is_solve, upper=upper
    )
    bt, bc = time_cotangents(t, c, bp, upper=upper)
    return bt, bc, bA, bB, bY


# ========================================================= factor + solve


def factor_solve_plain(p, a, U, V, Y):
    """The factor and the lower solve ``Z = L^{-1} Y`` in one plain loop
    over the rows (``celerite2_tpu.ops.scan.factor_solve_scan`` per chain).
    Returns ``(d, W, Z, S_half, F)``, equal to what :func:`factor_fwd_plain`
    and then :func:`sweep_fwd_plain` (a lower solve with ``A = U``, ``B =
    W``) return."""
    C, N, J = U.shape
    S = p.new_zeros(C, J, J)
    F = Y.new_zeros(C, J, Y.shape[-1])
    d_prev = p.new_zeros(C)
    w_prev = p.new_zeros(C, J)
    z_prev = Y.new_zeros(C, Y.shape[-1])
    ds, ws, zs, Ss, Fs = [], [], [], [], []
    for p_n, a_n, u_n, v_n, y_n in zip(
        p.unbind(1), a.unbind(1), U.unbind(1), V.unbind(1), Y.unbind(1)
    ):
        S = S + d_prev[:, None, None] * w_prev[:, :, None] * w_prev[:, None, :]
        S_half = p_n[:, :, None] * S
        S = S_half * p_n[:, None, :]
        tmp = (S * u_n[:, None, :]).sum(-1)
        d_prev = a_n - (u_n * tmp).sum(-1)
        F = F + w_prev[:, :, None] * z_prev[:, None, :]
        Fs.append(F)
        F = p_n[:, :, None] * F
        z_prev = y_n - (F * u_n[:, :, None]).sum(1)
        w_prev = (v_n - tmp) / _safe(d_prev)[:, None]
        ds.append(d_prev)
        ws.append(w_prev)
        zs.append(z_prev)
        Ss.append(S_half)
    return tuple(torch.stack(x, 1) for x in (ds, ws, zs, Ss, Fs))


def factor_solve(p, a, U, V, Y, *, want_cache=False):
    """The factor and the lower solve: the fused plain loop on the CPU, the
    factor and sweep kernels one after the other for CUDA tensors.
    Returns ``(d, W, Z, S_half, F)``; the caches are None unless
    ``want_cache``."""
    if p.device.type == "cpu":
        d, W, Z, S, F = factor_solve_plain(p, a, U, V, Y)
        return (d, W, Z) + ((S, F) if want_cache else (None, None))
    d, W, S = factor_fwd(p, a, U, V, want_cache=want_cache)
    Z, F = sweep_fwd(p, U, W, Y, is_solve=True, upper=False,
                     want_cache=want_cache)
    return d, W, Z, S, F


def factor_solve_scan(t, c, a, U, V, Y):
    """``(d, W, Z, S_half, F)`` of the fused factor and lower solve."""
    return factor_solve_plain(transport(t, c), a, U, V, Y)


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


# lanes a tile of the diagonal-affine kernel (csrc/assoc_prefix.cu
# affine_prefix_kernel: a tile is 32 runs of rows, a lane each)
KERNEL_RUNS = 32


def affine_prefix_tiled(phi, G, *, reverse=False, run):
    """The diagonal-affine prefix in the order of its CUDA kernel
    (``_build.affine_prefix_cuda``): tiles of :data:`KERNEL_RUNS` runs of
    ``run`` rows; each run's (alpha, beta) composed in order, a doubling
    over the tile's runs, the value carried over the tiles' aggregates in
    order (the kernel's look-back when every earlier tile has published its
    inclusive value; otherwise the kernel composes the aggregates of the
    tiles back to the nearest one that has), each run's rows again from the
    value entering it.  Returns what :func:`affine_prefix_plain` returns.
    A plain version of the kernel's order, for the tests on the CPU;
    nothing on the card's path calls it."""
    C, M, J, K = G.shape
    alpha, beta = phi[..., None].expand_as(G), G
    if reverse:
        alpha, beta = alpha.flip(1), beta.flip(1)
    tile = KERNEL_RUNS * run
    pad = -M % tile
    alpha = torch.cat([alpha, alpha.new_ones(C, pad, J, K)], 1)
    beta = torch.cat([beta, beta.new_zeros(C, pad, J, K)], 1)
    T = alpha.shape[1] // tile
    alpha = alpha.reshape(C, T, KERNEL_RUNS, run, J, K)
    beta = beta.reshape(C, T, KERNEL_RUNS, run, J, K)
    a, f = alpha.new_ones(C, T, KERNEL_RUNS, J, K), beta.new_zeros(C, T, KERNEL_RUNS, J, K)
    for r in range(run):
        f = alpha[:, :, :, r] * f + beta[:, :, :, r]
        a = alpha[:, :, :, r] * a
    k = 1
    while k < KERNEL_RUNS:  # inclusive over the runs of a tile
        f = torch.cat([f[:, :, :k], a[:, :, k:] * f[:, :, :-k] + f[:, :, k:]], 2)
        a = torch.cat([a[:, :, :k], a[:, :, k:] * a[:, :, :-k]], 2)
        k *= 2
    x, entering = f.new_zeros(C, J, K), []
    for t in range(T):
        entering.append(x)
        x = a[:, t, -1] * x + f[:, t, -1]
    x = torch.stack(entering, 1)[:, :, None]
    ea = torch.cat([torch.ones_like(a[:, :, :1]), a[:, :, :-1]], 2)
    ef = torch.cat([torch.zeros_like(f[:, :, :1]), f[:, :, :-1]], 2)
    v, out = ea * x + ef, []
    for r in range(run):
        v = alpha[:, :, :, r] * v + beta[:, :, :, r]
        out.append(v)
    F = torch.stack(out, 3).reshape(C, T * tile, J, K)[:, :M]
    return F.flip(1) if reverse else F


def affine_prefix(phi, G, *, reverse=False):
    """The affine prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU."""
    if G.device.type == "cpu":
        return affine_prefix_plain(phi, G, reverse=reverse)
    return _build.affine_prefix_cuda(phi, G, reverse)
