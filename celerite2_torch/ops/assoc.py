"""The assoc tier: the general ops as prefixes of monoid elements over the
rows, for one long sequence.

Counterpart of ``celerite2_tpu/ops/assoc.py``.  The sequential recursions
of ``ops/scan.py`` are reformulated as inclusive prefixes of associative
elements (the JAX module's docstring derives them), which
``ops/prefix_engine.py`` composes in blocks of rows side by side:

* ``factor``: the Riccati family (A, Q, R); the carry S is the Q leaf;
* ``factor_solve``: the Kalman family (A, Q, R, b, eta), one pass for the
  factor and the lower solve (the JAX form under ``fused_forward=True``);
* the solves: the matrix-affine family x -> A x + b on J x J maps;
* the matmuls: the diagonal-affine family (``scan.affine_prefix``);
* the adjoints: the solve adjoint on matrix-affine J x J maps, the matmul
  adjoint on diagonal-affine maps, and the factor adjoint on matrix-affine
  maps of the J^2 entries of its carry: per-row maps at J <= 2
  (``_frev_suffix_states_dense``), per-block maps above.  At J = 3, 4 the
  fused path's kernels K4 and K5 run the three phases
  (``_frev_states_k45``); above, phases A and C are loops in PyTorch over
  the steps of a block, batched over blocks and chains, and phase B is the
  matrix-affine prefix at D = J^2 over the block maps
  (``_frev_suffix_states``).

Every function returns exactly what its scan-tier twin returns, caches
included (``S_half (C, N, J, J)``, ``F (C, N, J, K)``), so the adjoints of
either tier take the caches of either.  The functions that take the
transport ``p`` (``factor_fwd``, ``sweep_fwd``, ``factor_solve``,
``factor_bwd``, ``sweep_bwd``) have the signatures of ``ops/scan.py``'s and
are what ``ops/dispatch.py`` routes to; the ``*_assoc`` functions are the
JAX signatures on top of them, with a leading chain axis.

The element algebra (``riccati_combine``, ``kalman_combine``,
``mat_affine_combine`` and their distribute variants, with the clamped
small inverse ``inv_clamped``) lives in ``ops/elements.py`` and is
re-exported here under the JAX module's names.
"""

from __future__ import annotations

import torch

from celerite2_torch.ops import elements as el
from celerite2_torch.ops import fused_loglik as _fl
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan as _scan
from celerite2_torch.ops.prefix_engine import shift_rows as _shift
from celerite2_torch.ops.scan import _safe

__all__ = [
    "riccati_combine",
    "riccati_distribute_Q",
    "kalman_combine",
    "kalman_distribute",
    "mat_affine_combine",
    "affine_distribute_b",
    "small_inv",
    "factor_fwd",
    "factor_solve",
    "sweep_fwd",
    "solve_elements",
    "factor_bwd",
    "sweep_bwd",
    "frev_apply",
    "pair_dim",
    "pair_rev_apply",
    "pair_dense_elements",
    "pair_row_outputs",
    "frev_block_len",
    "frev_step_maps",
    "factor_assoc",
    "factor_solve_assoc",
    "solve_lower_assoc",
    "solve_upper_assoc",
    "matmul_lower_assoc",
    "matmul_upper_assoc",
    "sweep_rev_assoc",
    "factor_rev_assoc",
]

# the element algebra, under the JAX module's names
riccati_combine = el.riccati_combine
riccati_distribute_Q = el.riccati_distribute
kalman_combine = el.kalman_combine
kalman_distribute = el.kalman_distribute
mat_affine_combine = el.affine_combine
affine_distribute_b = el.affine_distribute
small_inv = el.inv_clamped


def _outer(x, y):
    return x[..., :, None] * y[..., None, :]


def _mv(M, x):
    """``(..., n, m) @ (..., m)``, as a sum (no TF32 in float32)."""
    return (M * x[..., None, :]).sum(-1)


# ============================================================= forward


def _factor_outputs(p, a, U, V, S_full, want_cache):
    """``d``, ``W`` and the one-sided cache ``S_half`` from the carry after
    every row (``assoc.factor_assoc`` :606-619)."""
    SU = _mv(S_full, U)
    d = a - (SU * U).sum(-1)
    W = (V - SU) / _safe(d)[..., None]
    if not want_cache:
        return d, W, None
    S_half = p[..., :, None] * (
        _shift(S_full, False) + _shift(d, False)[..., None, None]
        * _outer(_shift(W, False), _shift(W, False))
    )
    return d, W, S_half


def factor_fwd(p, a, U, V, *, want_cache=False):
    """The LDL^T factor through the Riccati prefix: ``(d, W, S_half)``, as
    ``scan.factor_fwd``."""
    S_full = pe.riccati_prefix(p, a, U, V)
    return _factor_outputs(p, a, U, V, S_full, want_cache)


def factor_solve(p, a, U, V, Y, *, want_cache=False):
    """The factor and the lower solve in one Kalman prefix: ``(d, W, Z,
    S_half, F)``, as ``scan.factor_solve``."""
    S_full, F_post = pe.kalman_prefix(p, a, U, V, Y)
    d, W, S_half = _factor_outputs(p, a, U, V, S_full, want_cache)
    Z = Y - (U[..., :, None] * F_post).sum(-2)
    F = None
    if want_cache:
        F = _shift(F_post, False) + _outer(_shift(W, False), _shift(Z, False))
    return d, W, Z, S_half, F


def solve_elements(p, A, B, Y, upper=False):
    """The matrix-affine elements of a solve: ``x -> diag(p_n)(I - b a^T) x
    + diag(p_n) b y^T`` with row n - 1's a, b, y (row n + 1's for an upper
    solve), as ``(C, N, J, J)`` and ``(C, N, J, K)``."""
    Bp = _shift(B, upper)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Mat = p[..., :, None] * (eye - _outer(Bp, _shift(A, upper)))
    return Mat, p[..., :, None] * _outer(Bp, _shift(Y, upper))


def sweep_fwd(p, A, B, Y, *, is_solve, upper, want_cache=False):
    """A sweep, as ``scan.sweep_fwd``: ``A`` projects, ``B`` feeds the
    carry.  A solve runs the matrix-affine prefix of
    :func:`solve_elements` (in reverse for an upper sweep); a matmul the
    diagonal-affine prefix."""
    Bp, Yp = _shift(B, upper), _shift(Y, upper)
    if is_solve:
        F_post = pe.mat_affine_prefix(*solve_elements(p, A, B, Y, upper),
                                      reverse=upper)
        Z = Y - (A[..., :, None] * F_post).sum(-2)
    else:
        F_post = _scan.affine_prefix(
            p, (p[..., :, None] * _outer(Bp, Yp)).contiguous(), reverse=upper)
        Z = (A[..., :, None] * F_post).sum(-2)
    F = None
    if want_cache:
        R = Z if is_solve else Y
        F = _shift(F_post, upper) + _outer(Bp, _shift(R, upper))
    return Z, F


def factor_assoc(t, c, a, U, V):
    """``(d, W, S_half)`` of C systems (``celerite2_tpu.ops.assoc
    .factor_assoc`` per chain)."""
    return factor_fwd(_scan.transport(t, c), a, U, V, want_cache=True)


def factor_solve_assoc(t, c, a, U, V, Y):
    """``(d, W, Z, S_half, F)`` (``assoc.factor_solve_assoc`` per chain)."""
    return factor_solve(_scan.transport(t, c), a, U, V, Y, want_cache=True)


def _sweep(t, c, A, B, Y, *, is_solve, upper):
    p = _scan.transport_up(t, c) if upper else _scan.transport(t, c)
    return sweep_fwd(p, A, B, Y, is_solve=is_solve, upper=upper, want_cache=True)


def solve_lower_assoc(t, c, U, W, Y):
    """``(Z, F)`` with Z = L^{-1} Y."""
    return _sweep(t, c, U, W, Y, is_solve=True, upper=False)


def solve_upper_assoc(t, c, U, W, Y):
    """``(Z, F)`` with Z = L^{-T} Y."""
    return _sweep(t, c, W, U, Y, is_solve=True, upper=True)


def matmul_lower_assoc(t, c, U, V, Y):
    """``(Z, F)`` with Z = tril_strict(U V^T (x) transport) @ Y."""
    return _sweep(t, c, U, V, Y, is_solve=False, upper=False)


def matmul_upper_assoc(t, c, U, V, Y):
    """``(Z, F)`` with Z = triu_strict(V U^T (x) transport) @ Y."""
    return _sweep(t, c, V, U, Y, is_solve=False, upper=True)


# ============================================================ adjoints


def _live_chains(*cotangents):
    """``(C,)``: whether any cotangent entry of a chain is non-zero.  The
    adjoints are linear in the cotangents, so a chain without one has zero
    gradients exactly; its forward may have overflowed (a system that is
    not positive definite can drive the carry walk's solves anywhere), and
    :func:`_only_live` keeps that out of its gradients."""
    live = (cotangents[0] != 0).flatten(1).any(-1)
    for x in cotangents[1:]:
        live = live | (x != 0).flatten(1).any(-1)
    return live


def _only_live(live, *outs):
    """``outs (C, ...)`` with the chains that are not ``live`` set to zero,
    NaN and inf included."""
    return tuple(torch.where(live.view(-1, *[1] * (x.dim() - 1)), x, 0.0)
                 for x in outs)


def sweep_bwd(p, A, B, R, F, bZ, *, is_solve, upper):
    """The sweep adjoint, as ``scan.sweep_bwd``: ``(bA, bB, bp, bY)``
    (``assoc.sweep_rev_assoc``).  The carried cotangent is affine in
    itself: matrix-affine J x J maps for a solve, diagonal-affine for a
    matmul, composed against the forward's direction.  A chain with zero
    cotangents gets zero gradients."""
    J, K = A.shape[-1], bZ.shape[-1]
    sign = -1.0 if is_solve else 1.0
    st = slice(None, -1) if upper else slice(1, None)  # the active steps
    fd = slice(1, None) if upper else slice(None, -1)  # their feeder rows
    ps, An, Bn, bZn, Fn = p[:, st], A[:, st], B[:, st], bZ[:, st], F[:, st]
    if is_solve:
        eye = torch.eye(J, dtype=A.dtype, device=A.device)
        Mat = ps[..., :, None] * (eye - _outer(An, Bn))
        Rs = pe.mat_affine_prefix(
            Mat, -ps[..., :, None] * _outer(An, bZn), reverse=not upper)
    else:
        Rs = _scan.affine_prefix(
            ps.contiguous(), (sign * ps[..., :, None] * _outer(An, bZn)).contiguous(),
            reverse=not upper)
    zero = torch.zeros_like(Rs[:, :1])
    bF_in = torch.cat([zero, Rs[:, :-1]], 1) if upper else torch.cat([Rs[:, 1:], zero], 1)
    bz = bZn + (bF_in * Bn[..., :, None]).sum(-2) if is_solve else bZn
    bA_s = sign * _mv(ps[..., :, None] * Fn, bz)
    mid = bF_in + sign * _outer(An, bz)
    bp_s = (Fn * mid).sum(-1) * ps
    post = ps[..., :, None] * mid
    dbB = _mv(post, R[:, fd])
    dbR = (post * B[:, fd][..., :, None]).sum(-2)

    zJ = torch.zeros_like(A[:, :1])
    zK = torch.zeros_like(bZ[:, :1])

    def at_steps(x, z):  # the step rows' values, zero at the other row
        return torch.cat([x, z], 1) if upper else torch.cat([z, x], 1)

    def at_feeds(x, z):
        return torch.cat([z, x], 1) if upper else torch.cat([x, z], 1)

    if is_solve:
        if upper:
            bY = torch.cat([bz, bZ[:, -1:] + dbR[:, -1:]], 1)
        else:
            bY = torch.cat([bZ[:, :1] + dbR[:, :1], bz], 1)
    else:
        bY = at_feeds(dbR, zK)
    return _only_live(_live_chains(bZ), at_steps(bA_s, zJ), at_feeds(dbB, zJ),
                      at_steps(bp_s, zJ), bY)


def frev_apply(M, par, *, affine):
    """One step of the factor adjoint on the carried ``M (..., J, J)``
    (``assoc._frev_apply``):

        bv = [bv0] + (M + M^T) w;  ba = [bdp] - w^T M w
        M' = diag(p) (M - u bv^T - ba u u^T) diag(p)

    ``affine=False`` drops the bracketed constants (the linear part)."""
    p, u, w, bv0, bdp = par
    Mw = _mv(M, w)
    bv = Mw + _mv(M.mT, w)
    ba = -(w * Mw).sum(-1)
    if affine:
        bv = bv + bv0
        ba = ba + bdp
    mid = M - _outer(u, bv) - ba[..., None, None] * _outer(u, u)
    return p[..., :, None] * mid * p[..., None, :]


# ------------------------------------------------- paired reverse pass
#
# The log-likelihood's backward is the solve adjoint, then the factor
# adjoint, coupled through bW one row later; both carries evolve affinely in
# the same (decreasing-row) step order, so one affine state
#
#     x = [bF (J), dbR (1), dbB (J), vec(bS) (J^2)]
#
# runs both (assoc.py's paired reverse pass, K = 1).  dbR and dbB are the
# one-step deferrals of the solve's contributions to the next row's bz and
# bW.  The sequence-sharded log-likelihood (``parallel.sharded``) runs it
# as a matrix-affine prefix of the dense per-step maps.


def pair_dim(J):
    """The paired state's width, ``J^2 + 2J + 1`` (``assoc._pair_dim``)."""
    return 2 * J + 1 + J * J


def pair_rev_apply(x, par, *, affine):
    """One joint (solve and factor) reverse step on the flat state ``x (...,
    D)`` (``assoc._pair_rev_apply``); ``par = (p, u, w, w_prev, z_prev, bZn,
    bWn, bdn, dinv)`` the step's row data, batched over the leading dims.
    ``affine=False``: the linear part alone."""
    p, u, w, w_prev, z_prev, bZn, bWn, bdn, dinv = par
    J = p.shape[-1]
    bF, dbR = x[..., :J], x[..., J]
    dbB = x[..., J + 1:2 * J + 1]
    M = x[..., 2 * J + 1:].reshape(*x.shape[:-1], J, J)
    # the solve's step
    bz = dbR + bZn if affine else dbR
    bF_out = p * (bF - u * bz[..., None])
    dbR_out = (bF_out * w_prev).sum(-1)
    dbB_out = bF_out * z_prev[..., None]
    # the factor's step, on the dbB the later solve step deferred
    bv0 = dbB * dinv[..., None]
    bdp = -(w * bv0).sum(-1)
    if affine:
        bv0 = bv0 + bWn * dinv[..., None]
        bdp = bdp + bdn - (w * bWn).sum(-1) * dinv
    M_out = frev_apply(M, (p, u, w, bv0, bdp), affine=True)
    return torch.cat([bF_out, dbR_out[..., None], dbB_out,
                      M_out.reshape(*x.shape[:-1], J * J)], -1)


def pair_dense_elements(par, dim):
    """The dense per-step maps of the paired flow (``assoc._pair_dense_
    elements``): ``L (..., M, D, D)``, the linear part (column k the image
    of e_k, every basis vector pushed through :func:`pair_rev_apply` in one
    batched call), and ``c (..., M, D)`` the constant."""
    p = par[0]
    basis = torch.eye(dim, dtype=p.dtype, device=p.device).expand(
        *p.shape[:-1], dim, dim)
    cols = pair_rev_apply(basis, tuple(x[..., None, :] if x.dim() == p.dim() else
                                       x[..., None] for x in par), affine=False)
    c = pair_rev_apply(p.new_zeros(*p.shape[:-1], dim), par, affine=True)
    return cols.mT, c


def pair_row_outputs(x_in, p, u, w, F_rows, S_half, bZ_s, bW_s, bd_s, dinv_s):
    """Each step's outputs of the paired reverse flow from the state
    entering it (``assoc._pair_row_outputs``): ``(bz, bU, bv, ba, bp)``, the
    right-hand side's cotangent, U's (the solve's and the factor's parts),
    V's, the diagonal's and the transport's."""
    J = p.shape[-1]
    bF_in, dbR_in = x_in[..., :J], x_in[..., J]
    dbB_in = x_in[..., J + 1:2 * J + 1]
    M_in = x_in[..., 2 * J + 1:].reshape(*x_in.shape[:-1], J, J)
    # the solve's part
    bz = bZ_s + dbR_in
    bF_mid = bF_in - u * bz[..., None]
    bU1 = -(p * F_rows) * bz[..., None]
    bp1 = F_rows * bF_mid * p
    # the factor's part
    bv0 = (bW_s + dbB_in) * dinv_s[..., None]
    bdp = bd_s - (w * bv0).sum(-1)
    bv = bv0 + _mv(M_in + M_in.mT, w)
    ba = bdp - (w * _mv(M_in, w)).sum(-1)
    S_full = S_half * p[..., None, :]
    bU2 = -_mv(S_full, bv + 2.0 * ba[..., None] * u)
    mid = M_in - _outer(u, bv) - ba[..., None, None] * _outer(u, u)
    bp2 = ((mid * S_half.mT).sum(-1) + (S_half * mid).sum(-2)) * p
    return bz, bU1 + bU2, bv, ba, bp1 + bp2


def frev_block_len(C, M, J):
    """Steps per block of the structured factor adjoint: the smallest power
    of two from 32 up that leaves at most 128 blocks, or more steps if the
    block maps of all chains, C ceil(M / L) J^4 entries, would pass 2^27
    (1 GiB in float64).  Few, long blocks: the adjoint's step maps reach
    norms of 1e5 (the stiff terms' large w), and every block map that phase
    B composes loses digits (at M = 1e5, J = 8 blocks of 32 steps put bp
    3e-7 from the row recursion, blocks of 1024 steps 7e-12)."""
    L = 32
    while L < M and (-(-M // L) > 128 or C * -(-M // L) * J**4 > 2**27):
        L *= 2
    return L


def _frev_suffix_states(par):
    """The carry entering every step of the factor adjoint, ``(C, M, J,
    J)``, for steps given in ascending order and applied descending
    (``assoc._frev_suffix_states``):

    A. per block, the J^2 basis matrices and the zero state pushed through
       the block's steps (a loop over the block's steps, batched over
       blocks and chains) give the block's dense map;
    B. the matrix-affine prefix of the block maps (D = J^2, K = 1) gives
       the state entering every block;
    C. every block's steps again from that state, keeping the carry
       entering each."""
    p = par[0]
    C, M, J = p.shape
    L = min(frev_block_len(C, M, J), M)
    NB = -(-M // L)
    pad = NB * L - M
    app = [x.flip(1) for x in par]  # application order
    if pad:
        ident = (torch.ones_like(p[:, :pad]),) + tuple(
            torch.zeros_like(x[:, :pad]) for x in app[1:])
        app = [torch.cat([x, i], 1) for x, i in zip(app, ident)]
    # (C, NB * L, ...) -> (L, C, NB, ...): step-major within blocks
    steps = [x.reshape(C, NB, L, *x.shape[2:]).movedim(2, 0) for x in app]

    # the J^2 basis matrices and, last, the zero state, pushed through the
    # steps together: the constants act on the last channel only
    eye = torch.eye(J * J + 1, dtype=p.dtype, device=p.device)
    Bas = eye[:, :-1].reshape(J * J + 1, J, J).expand(C, NB, J * J + 1, J, J)
    affine = eye[-1]
    for s in range(L):
        p_s, u_s, w_s, bv0_s, bdp_s = (x[s] for x in steps)
        Bas = frev_apply(Bas, (p_s[:, :, None], u_s[:, :, None], w_s[:, :, None],
                               bv0_s[:, :, None] * affine[:, None],
                               bdp_s[:, :, None] * affine), affine=True)
    # column k of a block map is the image of basis matrix k
    maps = Bas[:, :, :-1].reshape(C, NB, J * J, J * J).mT.contiguous()
    states = pe.mat_affine_prefix(maps, Bas[:, :, -1].reshape(C, NB, J * J, 1))
    M_in = torch.cat([p.new_zeros(C, 1, J * J), states[:, :-1, :, 0]], 1)
    X = M_in.reshape(C, NB, J, J)
    out = []
    for s in range(L):
        out.append(X)
        X = frev_apply(X, tuple(x[s] for x in steps), affine=True)
    M_pre = torch.stack(out, 2).reshape(C, NB * L, J, J)[:, :M]
    return M_pre.flip(1)


def frev_step_maps(p, u, w, bv0, bdp):
    """Each step of the factor adjoint as a dense affine map of the J^2
    entries of its carry: ``(Lin (C, M, J^2, J^2), Cv (C, M, J^2, 1))`` with

        dM'[jk] / dM[lm] = p_j p_k [d_jl d_km - u_j (d_kl w_m + d_km w_l)
                                    + u_j u_k w_l w_m]

    and ``Cv`` the step applied to zero."""
    C, M, J = p.shape
    eye = torch.eye(J, dtype=p.dtype, device=p.device)
    T1 = eye[:, None, :, None] * eye[None, :, None, :]
    uj = u[..., :, None, None, None]
    uk = u[..., None, :, None, None]
    wl = w[..., None, None, :, None]
    wm = w[..., None, None, None, :]
    T2 = uj * (eye[None, :, :, None] * wm + eye[None, :, None, :] * wl)
    T3 = uj * uk * wl * wm
    pj = p[..., :, None, None, None]
    pk = p[..., None, :, None, None]
    Lin = (pj * pk * (T1 - T2 + T3)).reshape(C, M, J * J, J * J)
    mid0 = -_outer(u, bv0) - bdp[..., None, None] * _outer(u, u)
    Cv = (p[..., :, None] * mid0 * p[..., None, :]).reshape(C, M, J * J, 1)
    return Lin.contiguous(), Cv.contiguous()


def _frev_suffix_states_dense(p, u, w, bv0, bdp):
    """Per-step dense variant of :func:`_frev_suffix_states`
    (``assoc._frev_suffix_states_dense``): the steps' maps
    (:func:`frev_step_maps`) composed by the matrix-affine prefix in
    reverse.  O(M J^4) memory: for J <= 2."""
    C, M, J = p.shape
    R = pe.mat_affine_prefix(*frev_step_maps(p, u, w, bv0, bdp), reverse=True)
    R = R.reshape(C, M, J, J)
    return torch.cat([R[:, 1:], torch.zeros_like(R[:, :1])], 1)


def _frev_states_k45(p, U, W, bv0, bdp):
    """The factor adjoint's carry at every row at J = 3, 4 through the
    fused path's kernels: K4 (``frev_maps``, phase A) for each block's map
    and the suffixes within its group of blocks, K5 (``frev_states``) for
    the rest of phase B, the state entering each group and block, and
    phase C, the rows.  Returns ``(C, N, J, J)``: the state entering step n
    at rows n >= 1, the state after every step at row 0."""
    L = _fl.default_block_len(U.shape[1])
    return _fl.factor_adjoint(p, U, W, bv0, bdp, L, structured=True)


def factor_bwd(p, d, U, W, S_half, bd, bW):
    """The factor adjoint, as ``scan.factor_bwd``: ``(ba, bU, bV, bp)``
    (``assoc.factor_rev_assoc``).  A non-positive pivot divides by 1, as in
    the forward; a chain with zero cotangents gets zero gradients."""
    C, N, J = U.shape
    bv0 = bW / _safe(d)[..., None]
    bdp = bd - (W * bv0).sum(-1)
    par = (p[:, 1:], U[:, 1:], W[:, 1:], bv0[:, 1:], bdp[:, 1:])
    M0 = None
    if N < 2:
        M_in, M0 = U.new_zeros(C, 0, J, J), U.new_zeros(C, J, J)
    elif J <= 2:
        M_in = _frev_suffix_states_dense(*par)
    elif J <= 4:
        MX = _frev_states_k45(p, U, W, bv0, bdp)
        M_in, M0 = MX[:, 1:], MX[:, 0]
    else:
        M_in = _frev_suffix_states(par)
    if M0 is None:  # the state after step 1: every step composed
        M0 = frev_apply(M_in[:, 0], tuple(x[:, 0] for x in par), affine=True)
    ps, u, w, bv0n, bdpn = par
    bv = bv0n + _mv(M_in + M_in.mT, w)
    ba = bdpn - (w * _mv(M_in, w)).sum(-1)
    Sh = S_half[:, 1:]
    bU_s = -_mv(Sh * ps[..., None, :], bv + 2.0 * ba[..., None] * u)
    mid = M_in - _outer(u, bv) - ba[..., None, None] * _outer(u, u)
    bp_s = ((mid * Sh.mT).sum(-1) + (Sh * mid).sum(-2)) * ps
    W0 = W[:, 0]
    bv_0 = bv0[:, 0] + _mv(M0 + M0.mT, W0)
    ba_0 = bd[:, 0] + (W0 * _mv(M0, W0)).sum(-1) - (bv_0 * W0).sum(-1)
    zJ = torch.zeros_like(U[:, :1])
    return _only_live(_live_chains(bd, bW), torch.cat([ba_0[:, None], ba], 1),
                      torch.cat([zJ, bU_s], 1), torch.cat([bv_0[:, None], bv], 1),
                      torch.cat([zJ, bp_s], 1))


def sweep_rev_assoc(t, c, A, B, Y, Z, F, bZ, *, is_solve, upper):
    """Adjoint of a sweep: ``(bt, bc, bA, bB, bY)`` (``assoc
    .sweep_rev_assoc`` per chain)."""
    p = _scan.transport_up(t, c) if upper else _scan.transport(t, c)
    bA, bB, bp, bY = sweep_bwd(p, A, B, Z if is_solve else Y, F, bZ,
                               is_solve=is_solve, upper=upper)
    bt, bc = _scan.time_cotangents(t, c, bp, upper=upper)
    return bt, bc, bA, bB, bY


def factor_rev_assoc(t, c, a, U, V, d, W, S, bd, bW):
    """Adjoint of :func:`factor_assoc`: ``(bt, bc, ba, bU, bV)``
    (``assoc.factor_rev_assoc`` per chain)."""
    ba, bU, bV, bp = factor_bwd(_scan.transport(t, c), d, U, W, S, bd, bW)
    bt, bc = _scan.time_cotangents(t, c, bp)
    return bt, bc, ba, bU, bV
