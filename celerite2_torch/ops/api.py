"""The public semiseparable ops, at any celerite width J <= 32.

Counterpart of ``celerite2_tpu/ops/api.py``: ``factor``, ``factor_solve``,
the two solves, the two matmuls, the rectangular ``general_matmul_*`` and
``to_dense``.  Every op takes one system, with the JAX package's shapes
(``t (N,)``, ``c (J,)``, ``U (N, J)``, ``Y (N, K)``, ...), or C
independent systems at once, with a leading chain axis on every argument.

``factor``, ``factor_solve`` and the four sweeps are
``torch.autograd.Function``s.  Each runs on one of two tiers, which
``ops/dispatch.py`` picks once per call (the JAX package's
``dispatch._backend``): the sequential tier of ``ops/scan.py`` (the CUDA
kernels of ``csrc/general_ops.cu`` for CUDA tensors, the plain loop for CPU
tensors) or the assoc tier of ``ops/assoc.py`` (the blocked prefix kernels
of ``csrc/assoc_prefix.cu``, the doubling in plain PyTorch on the CPU).
The backward runs on the forward's tier: the hand-derived adjoints
(``factor_bwd``, ``sweep_bwd``; the JAX package's ``factor_rev`` and
``sweep_rev``), so autograd never differentiates through the row loop.  The adjoints read the forward's
caches (``S_half (C, N, J, J)``, ``F (C, N, J, K)``), which the forward
keeps only when a gradient will be asked for: under ``torch.no_grad()``,
or with nothing that requires a gradient, the forward runs without them.
``general_matmul_*`` accumulate with the affine prefix (the CUDA kernel for
CUDA tensors, a doubling in plain PyTorch on the CPU), which carries its
own adjoint, so like ``to_dense`` they are differentiable on either device.

Width bucketing: J is padded up to the next of ``config.J_BUCKETS`` before
the recursions run, with c = 1 and zero columns of the (N, J) matrices, so
the kernels exist for J in {1, 2, 4, 8, 16, 32} only.  The recursions are
exactly invariant to zero columns (the padded carry entries stay zero), and
the outputs and the cotangents are sliced back to J.
"""

from __future__ import annotations

import torch

from celerite2_torch.config import MAX_WIDTH, pad_width
from celerite2_torch.ops import dispatch as _dispatch
from celerite2_torch.ops import scan as _scan
from celerite2_torch.ops.spec import validate_call

__all__ = [
    "factor",
    "factor_solve",
    "solve_lower",
    "solve_upper",
    "matmul_lower",
    "matmul_upper",
    "general_matmul_lower",
    "general_matmul_upper",
    "to_dense",
]


def _bucketed(c, *mats):
    """Pad ``c (C, J)`` and the ``(C, N, J)`` matrices to the J bucket.

    Returns ``(c_p, mats_p, J)`` where ``J`` is the ORIGINAL width (what
    callers slice outputs back to).  Widths above ``MAX_WIDTH`` are left
    as they are: the plain loops take any width, the kernels refuse."""
    J = c.shape[-1]
    if J == 0 or J > MAX_WIDTH or pad_width(J) == J:
        return c, mats, J
    pad = pad_width(J) - J
    c_p = torch.cat([c, c.new_ones(*c.shape[:-1], pad)], -1)
    mats_p = tuple(torch.nn.functional.pad(m, (0, pad)) for m in mats)
    return c_p, mats_p, J


def _chains(batched, *args):
    """The arguments with the leading chain axis, contiguous."""
    return tuple((x if batched else x[None]).contiguous() for x in args)


def _wants_cache(ctx, grad_enabled):
    """Whether the forward keeps its caches: only when a gradient will be
    asked for (``grad_enabled`` is the caller's grad mode; inside
    ``forward`` it is always off)."""
    return grad_enabled and any(ctx.needs_input_grad)


def _cotangent(g, like, batched):
    """A cotangent as the adjoint recursions take it: zeros for None, with
    the chain axis, contiguous, and a width sliced from the bucket padded
    back with zero columns to that of ``like``."""
    if g is None:
        return torch.zeros_like(like)
    g = g if batched else g[None]
    if g.shape != like.shape:
        g = torch.nn.functional.pad(g, (0, like.shape[-1] - g.shape[-1]))
    return g.contiguous()


def _unchain(batched, *grads):
    return grads if batched else tuple(g[0] for g in grads)


# ============================================================== factor


class _Factor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, c, a, U, V, grad_enabled):
        batched = U.dim() == 3
        t, c, a, U, V = _chains(batched, t, c, a, U, V)
        c_p, (U_p, V_p), J = _bucketed(c, U, V)
        ctx.tier = _dispatch.tier(U, *U.shape)
        d, W_p, S = ctx.tier.factor_fwd(
            _scan.transport(t, c_p), a, U_p, V_p,
            want_cache=_wants_cache(ctx, grad_enabled),
        )
        if S is not None:
            ctx.save_for_backward(t, c_p, U_p, d, W_p, S)
        ctx.batched, ctx.J = batched, J
        W = W_p[..., :J]
        return (d, W) if batched else (d[0], W[0])

    @staticmethod
    def backward(ctx, bd, bW):
        t, c_p, U_p, d, W_p, S = ctx.saved_tensors
        batched, J = ctx.batched, ctx.J
        ba, bU, bV, bp = ctx.tier.factor_bwd(
            _scan.transport(t, c_p), d, U_p, W_p, S,
            _cotangent(bd, d, batched), _cotangent(bW, W_p, batched),
        )
        bt, bc = _scan.time_cotangents(t, c_p, bp)
        grads = (bt, bc[..., :J], ba, bU[..., :J], bV[..., :J])
        return (*_unchain(batched, *grads), None)


def factor(t, c, a, U, V):
    """LDL^T factorization: returns ``(d, W)``.

    ``K = L diag(d) L^T`` with ``L = I + tril_strict(U W^T (x) transport)``.
    A non-positive entry of ``d`` means the matrix is not positive
    definite; the division by such a pivot is guarded, so the result is
    finite and the caller checks ``(d > 0).all()``.
    """
    validate_call("factor", t, c, a, U, V)
    return _Factor.apply(t, c, a, U, V, torch.is_grad_enabled())


# ==================================================== factor + solve


class _FactorSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, c, a, U, V, Y, grad_enabled):
        batched = U.dim() == 3
        t, c, a, U, V, Y = _chains(batched, t, c, a, U, V, Y)
        c_p, (U_p, V_p), J = _bucketed(c, U, V)
        ctx.tier = _dispatch.tier(U, *U.shape)
        d, W_p, Z, S, F = ctx.tier.factor_solve(
            _scan.transport(t, c_p), a, U_p, V_p, Y,
            want_cache=_wants_cache(ctx, grad_enabled),
        )
        if S is not None:
            ctx.save_for_backward(t, c_p, U_p, d, W_p, Z, S, F)
        ctx.batched, ctx.J = batched, J
        W = W_p[..., :J]
        return (d, W, Z) if batched else (d[0], W[0], Z[0])

    @staticmethod
    def backward(ctx, bd, bW, bZ):
        """The chained adjoint (``dispatch.factor_solve_rev_impl`` with
        ``paired_reverse=False``): the lower solve's, then the factor's with
        ``bW`` plus what the solve gives W."""
        t, c_p, U_p, d, W_p, Z, S, F = ctx.saved_tensors
        batched, J = ctx.batched, ctx.J
        p = _scan.transport(t, c_p)
        bU1, bW1, bp1, bY = ctx.tier.sweep_bwd(
            p, U_p, W_p, Z, F, _cotangent(bZ, Z, batched),
            is_solve=True, upper=False,
        )
        ba, bU2, bV, bp2 = ctx.tier.factor_bwd(
            p, d, U_p, W_p, S, _cotangent(bd, d, batched),
            _cotangent(bW, W_p, batched) + bW1,
        )
        bt, bc = _scan.time_cotangents(t, c_p, bp1 + bp2)
        grads = (bt, bc[..., :J], ba, (bU1 + bU2)[..., :J], bV[..., :J], bY)
        return (*_unchain(batched, *grads), None)


def factor_solve(t, c, a, U, V, Y):
    """``factor`` and ``solve_lower`` in one op: returns ``(d, W, Z)`` with
    ``Z = L^{-1} Y``, the log-likelihood's forward.  On the scan tier one
    fused plain loop on the CPU, the factor and sweep kernels on the card;
    on the assoc tier one Kalman prefix.  Its gradient is
    the lower solve's adjoint followed by the factor's."""
    validate_call("factor_solve", t, c, a, U, V, Y)
    return _FactorSolve.apply(t, c, a, U, V, Y, torch.is_grad_enabled())


# =============================================================== sweeps

# name -> (is_solve, upper, swap): the upper sweeps project with the
# second factor and feed the carry with the first, so their adjoint gives
# (bB, bA) for (M1, M2)
_SWEEPS = {
    "solve_lower": (True, False, False),
    "solve_upper": (True, True, True),
    "matmul_lower": (False, False, False),
    "matmul_upper": (False, True, True),
}


class _Sweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, t, c, M1, M2, Y, grad_enabled):
        is_solve, upper, swap = _SWEEPS[name]
        batched = Y.dim() == 3
        t, c, M1, M2, Y = _chains(batched, t, c, M1, M2, Y)
        c_p, (M1_p, M2_p), J = _bucketed(c, M1, M2)
        A, B = (M2_p, M1_p) if swap else (M1_p, M2_p)
        p = _scan.transport_up(t, c_p) if upper else _scan.transport(t, c_p)
        ctx.tier = _dispatch.tier(A, *A.shape)
        Z, F = ctx.tier.sweep_fwd(p, A, B, Y, is_solve=is_solve, upper=upper,
                                  want_cache=_wants_cache(ctx, grad_enabled))
        if F is not None:
            # the rows that fed the forward carry: Z for a solve, Y else
            ctx.save_for_backward(t, c_p, A, B, Z if is_solve else Y, F)
        ctx.name, ctx.batched, ctx.J = name, batched, J
        return Z if batched else Z[0]

    @staticmethod
    def backward(ctx, bZ):
        t, c_p, A, B, R, F = ctx.saved_tensors
        is_solve, upper, swap = _SWEEPS[ctx.name]
        batched, J = ctx.batched, ctx.J
        p = _scan.transport_up(t, c_p) if upper else _scan.transport(t, c_p)
        bA, bB, bp, bY = ctx.tier.sweep_bwd(
            p, A, B, R, F, _cotangent(bZ, R, batched),
            is_solve=is_solve, upper=upper,
        )
        bt, bc = _scan.time_cotangents(t, c_p, bp, upper=upper)
        b1, b2 = (bB, bA) if swap else (bA, bB)
        grads = (bt, bc[..., :J], b1[..., :J], b2[..., :J], bY)
        return (None, *_unchain(batched, *grads), None)


def _sweep_op(name, doc):
    def op(t, c, M1, M2, Y):
        validate_call(name, t, c, M1, M2, Y)
        return _Sweep.apply(name, t, c, M1, M2, Y, torch.is_grad_enabled())

    op.__name__ = op.__qualname__ = name
    op.__doc__ = doc
    return op


solve_lower = _sweep_op(
    "solve_lower", "Z = L^{-1} Y (unit lower-triangular semiseparable solve)."
)
solve_upper = _sweep_op("solve_upper", "Z = L^{-T} Y.")
matmul_lower = _sweep_op(
    "matmul_lower", "Z = tril_strict(U V^T (x) transport) @ Y."
)
matmul_upper = _sweep_op(
    "matmul_upper", "Z = triu_strict(V U^T (x) transport) @ Y."
)


# ===================================================== general matmuls
#
# Rectangular cross-covariance products (prediction at new points).  The
# merge over the two sorted time axes is a searchsorted + gather against
# the scanned carry.


class _AffinePrefix(torch.autograd.Function):
    """``F_m = phi_m F_prev + G_m`` over the rows of ``G (C, M, J, K)``.

    The adjoint of an affine prefix is the affine prefix walked the other
    way, ``lam_m = bF_m + phi_next lam_next``, so ``backward`` runs the
    same recursion (the same kernel on the card): ``bG = lam`` and
    ``bphi_m = sum_k lam_m F_prev``."""

    @staticmethod
    def forward(ctx, phi, G, reverse):
        F = _scan.affine_prefix(phi, G, reverse=reverse)
        ctx.save_for_backward(phi, F)
        ctx.reverse = reverse
        return F

    @staticmethod
    def backward(ctx, bF):
        phi, F = ctx.saved_tensors
        zero = torch.zeros_like(phi[:, :1])
        if ctx.reverse:
            phi_next = torch.cat([zero, phi[:, :-1]], 1)
            F_prev = torch.cat([F[:, 1:], torch.zeros_like(F[:, :1])], 1)
        else:
            phi_next = torch.cat([phi[:, 1:], zero], 1)
            F_prev = torch.cat([torch.zeros_like(F[:, :1]), F[:, :-1]], 1)
        lam = _scan.affine_prefix(
            phi_next.contiguous(), bF.contiguous(), reverse=not ctx.reverse
        )
        return (lam * F_prev).sum(-1), lam, None


def _transported_cumulative(phi, G, *, reverse=False):
    """Inclusive transported cumulative ``F_m = phi_m * F_prev + G_m`` over
    the rows of ``G (..., M, J, K)``, with ``phi (..., M, J)``.

    On a TPU the JAX package runs this through its prefix engine
    (``assoc._diag_affine_scan``); here it is the blocked prefix kernel of
    ``csrc/general_ops.cu`` for CUDA tensors and a doubling in plain
    PyTorch on the CPU (``ops/scan.py``)."""
    batched = G.dim() == 4
    phi, G = _chains(batched, phi, G)
    F = _AffinePrefix.apply(phi, G, reverse)
    return F if batched else F[0]


def _gathered_product(t1, t2, c, U, F, idx, has_src, sign):
    """``U[n] . diag(exp(-c |t1[n] - t2[idx[n]]|)) F[idx[n]]``, zero where
    row n has no source point."""
    idx_c = idx.clamp(0, t2.shape[-1] - 1)
    t2_g = torch.take_along_dim(t2, idx_c, -1)
    decay = torch.exp(-c[..., None, :] * (sign * (t1 - t2_g))[..., None])
    Fg = torch.take_along_dim(F, idx_c[..., None, None], -3)  # (..., N, J, K)
    Z = ((U * decay)[..., None] * Fg).sum(-2)
    return torch.where(has_src[..., None], Z, torch.zeros_like(Z))


def general_matmul_lower(t1, t2, c, U, V, Y):
    """Z[n] = sum_{m: t2[m] <= t1[n]} U[n] . diag(e^{-c (t1[n]-t2[m])}) V[m] Y[m].

    ``t1 (N,)`` target points, ``t2 (M,)`` source points (both sorted),
    ``U (N, J)``, ``V (M, J)``, ``Y (M, K)`` -> ``Z (N, K)``.
    """
    validate_call("general_matmul_lower", t1, t2, c, U, V, Y)
    # F[m] = sum_{l <= m} diag(e^{-c (t2[m]-t2[l])}) V[l]^T Y[l]
    F = _transported_cumulative(
        _scan.transport(t2, c), V[..., :, None] * Y[..., None, :]
    )
    # index of the last source point with t2[m] <= t1[n]
    idx = torch.searchsorted(t2.contiguous(), t1.contiguous(), right=True) - 1
    return _gathered_product(t1, t2, c, U, F, idx, idx >= 0, 1.0)


def general_matmul_upper(t1, t2, c, U, V, Y):
    """Z[n] = sum_{m: t2[m] > t1[n]} U[n] . diag(e^{-c (t2[m]-t1[n])}) V[m] Y[m]."""
    validate_call("general_matmul_upper", t1, t2, c, U, V, Y)
    # reverse-time cumulative: F[m] = sum_{l >= m} transported V^T Y
    F = _transported_cumulative(
        _scan.transport_up(t2, c), V[..., :, None] * Y[..., None, :],
        reverse=True,
    )
    # first source point with t2[m] > t1[n]
    idx = torch.searchsorted(t2.contiguous(), t1.contiguous(), right=True)
    return _gathered_product(t1, t2, c, U, F, idx, idx < t2.shape[-1], -1.0)


# ============================================================= to_dense


def to_dense(t, c, a, U, V):
    """Materialize the dense celerite matrix (O(N^2 J); oracle only)."""
    validate_call("to_dense", t, c, a, U, V)
    tau = (t[..., :, None] - t[..., None, :]).abs()
    decay = torch.exp(-c[..., None, None, :] * tau[..., None])
    K = (U[..., :, None, :] * V[..., None, :, :] * decay).sum(-1)
    lower = torch.tril(K, diagonal=-1)
    return lower + lower.mT + torch.diag_embed(a)
