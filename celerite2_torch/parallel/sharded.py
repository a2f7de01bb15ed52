"""The GP log-likelihood and the GP ops with the sequence split over ranks.

Counterpart of ``celerite2_tpu/parallel/sharded.py``.  The recursions are
sequential over N; split over the ranks of a ``seq`` group, each rank holds
B consecutive rows and the ranks exchange O(J^2) carries, never rows:

1. **Boundary exchange**: each rank sends its last row's ``(t, a, U, V)``
   to its right neighbour, which builds the element that crosses the
   boundary (``comm.from_left``).
2. **Total maps and the carry**: each rank composes its rows' elements
   into one total map (the Riccati family's ``(A, Q, R)`` for the factor,
   the matrix-affine family's ``(P, q)`` for a solve; K6's total modes,
   ``prefix_engine.riccati_total`` and ``mat_affine_total``), the ranks
   all-gather them, and each composes those before its own into its
   incoming state.
3. **Local pass**: the prefix from the incoming state (K6's carry modes:
   ``riccati_prefix(..., prev, S0)``, ``mat_affine_prefix(..., x0)``), and
   the reductions (``comm.psum``).

The diagonal-affine family (the matmuls and the rectangular products)
needs no kernel mode: its map's linear part is ``exp(-c (t_r - t_in))``,
which telescopes, so the incoming carry is added after ``affine_prefix``.
Cross-rank traffic: O(ranks J^2) values a call, O(ranks D^2) in the
adjoint (D = J^2 + 2J + 1), whatever N.

Shapes: the chain axis leads, as in the port's ops: ``c (C, J)``, ``a
(C, B)``, ``U, V (C, B, J)`` of this rank's rows, with shared ``t (B,)``; a
right-hand side ``y`` is ``(B,)`` (shared), ``(C, B)`` or ``(C, B, K)``.
``group`` is the ``seq`` group (``Mesh.seq_group``); None runs one shard.

Gradients: :func:`sharded_loglik` carries the hand-derived adjoint of the
JAX package (``_sharded_loglik_bwd``), the paired solve and factor reverse
flow run as a reverse ``mat_affine_prefix`` from the cross-rank incoming
state.  It returns each rank's share of the gradient of a replicated input
(``c``, and whatever made ``a, U, V`` from shared parameters): pass shared
parameters through ``comm.varying`` first, as :func:`make_sharded_logdensity`
and ``make_hmc_train_step`` do, and the gradient is whole on every rank.
The other functions have no gradient (they raise when one would be needed;
ROADMAP D10); the JAX package gets theirs by autodiff through ``shard_map``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from celerite2_torch.ops import assoc
from celerite2_torch.ops import elements as el
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan
from celerite2_torch.ops.api import _gathered_product
from celerite2_torch.parallel import comm
from celerite2_torch.parallel.mesh import seq_sharding
from celerite2_torch.utils.misc import resolve_device

__all__ = [
    "sharded_loglik",
    "sharded_factor",
    "sharded_solve_lower",
    "sharded_solve_upper",
    "sharded_matmul_lower",
    "sharded_matmul_upper",
    "sharded_apply_inverse",
    "sharded_dot_tril",
    "sharded_predict_mean",
    "sharded_predict_mean_at",
    "sharded_general_matmul_lower",
    "sharded_general_matmul_upper",
    "sharded_conditional_variance",
    "sharded_conditional_covariance",
    "make_sharded_logdensity",
    "sharded_sample_conditional",
    "make_sharded_conditional_sampler",
]

LOG2PI = math.log(2.0 * math.pi)
_safe = scan._safe


def _no_gradient(fn):
    """The sharded ops other than the log-likelihood have no adjoint: they
    run without a graph, and raise where a gradient would be asked for."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in (*args, *kwargs.values())):
            raise NotImplementedError(
                f"{fn.__name__} has no gradient (ROADMAP D10): only "
                "sharded_loglik carries an adjoint")
        with torch.no_grad():
            return fn(*args, **kwargs)

    return wrapper


def _outer(x, y):
    return x[..., :, None] * y[..., None, :]


def _mv(M, x):
    return (M * x[..., None, :]).sum(-1)


def _rhs(y, C):
    """``y`` as right-hand sides ``(C, B, K)`` and whether it was a vector."""
    if y.dim() == 3:
        return y, False
    return y.expand(C, y.shape[-1])[..., None], True


def _transport(t, c, t_in, group):
    """``phi (C, B, J)`` against the previous global row, ``dt (C, B)``: row
    0 against the left neighbour's last time ``t_in (C,)``, and zero on the
    group's first rank (nothing enters the global first row)."""
    t = t.expand(c.shape[0], t.shape[-1])
    dt = t - torch.cat([t_in[:, None], t[:, :-1]], 1)
    phi = torch.exp(-c[:, None, :] * dt[..., None])
    if comm.index(group) == 0:
        phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], 1)
    return phi, dt


def _transport_up(t, c, t_out, group):
    """``phi_up (C, B, J)`` against the next global row (row B - 1 against
    the right neighbour's first time ``t_out (C,)``), zero on the global
    last row."""
    t = t.expand(c.shape[0], t.shape[-1])
    dt = torch.cat([t[:, 1:], t_out[:, None]], 1) - t
    phi = torch.exp(-c[:, None, :] * dt[..., None])
    if comm.index(group) == comm.size(group) - 1:
        phi = torch.cat([phi[:, :-1], torch.zeros_like(phi[:, :1])], 1)
    return phi


def _fold(maps, idx, combine, later_first):
    """The composition of the ranks' maps before ``idx`` (``later_first``:
    after it, the highest first), ``maps`` a tuple of ``(ranks, ...)``
    leaves; None where there is none."""
    order = range(maps[0].shape[0] - 1, idx, -1) if later_first else range(idx)
    acc = None
    for k in order:
        m = tuple(x[k] for x in maps)
        acc = m if acc is None else combine(acc, m)
    return acc


def _affine_in(P, q, group, later_first=False):
    """The value entering this rank of the matrix-affine flow whose ranks'
    total maps are ``(P (C, D, D), q (C, D, K))``: the maps of the ranks
    before it (``later_first``: after it) composed, applied to zero; None
    on the first rank of the flow."""
    g = comm.all_gather(torch.cat([P, q], -1), group)
    D = P.shape[-1]
    acc = _fold((g[..., :D], g[..., D:]), comm.index(group), el.affine_combine,
                later_first)
    return None if acc is None else acc[1].contiguous()


# ================================================================ factor


def _factor(t, c, a, U, V, group):
    """The sharded factor: ``(d, W, S, phi, dt, prev)`` with ``S (C, B, J,
    J)`` the carry after every row (the state each row's d and W read)."""
    C, B, J = U.shape
    t_in, a_in, U_in, V_in = comm.from_left(
        t.expand(C, B)[:, -1], a[:, -1], U[:, -1], V[:, -1], group=group)
    phi, dt = _transport(t, c, t_in, group)
    prev = (a_in.contiguous(), U_in.contiguous(), V_in.contiguous())
    S0 = None
    if comm.size(group) > 1:
        tot = pe.riccati_total(phi, a, U, V, prev=prev)
        g = comm.all_gather(torch.stack(tot, 1), group)
        acc = _fold(g.unbind(2), comm.index(group), el.riccati_combine, False)
        S0 = None if acc is None else acc[1].contiguous()
    S = pe.riccati_prefix(phi, a, U, V, prev=prev, S0=S0)
    SU = _mv(S, U)
    d = a - (U * SU).sum(-1)
    W = (V - SU) / _safe(d)[..., None]
    return d, W, S, phi, dt, prev


def _all_ok(d, group):
    """Whether every rank's pivots are positive, a chain each ``(C,)``."""
    return comm.psum((d > 0).all(-1).to(d.dtype), group) == comm.size(group)


@_no_gradient
def sharded_factor(t, c, a, U, V, *, group=None):
    """Sequence-sharded LDL^T: this rank's ``(d (C, B), W (C, B, J))`` and
    ``ok (C,)`` (positive definite on every rank)."""
    d, W, *_ = _factor(t, c, a, U, V, group)
    return d, W, _all_ok(d, group)


# ================================================================ solves


def _solve_lower(t, c, U, W, Y, group):
    """``Z = L^{-1} Y`` and the solve's state after every row, ``F (C, B, J,
    K)``, on ``Y (C, B, K)``."""
    C, B, J = U.shape
    t_in, U_in, W_in, Y_in = comm.from_left(
        t.expand(C, B)[:, -1], U[:, -1], W[:, -1], Y[:, -1], group=group)
    phi, _ = _transport(t, c, t_in, group)
    Up = torch.cat([U_in[:, None], U[:, :-1]], 1)
    Wp = torch.cat([W_in[:, None], W[:, :-1]], 1)
    Yp = torch.cat([Y_in[:, None], Y[:, :-1]], 1)
    eye = torch.eye(J, dtype=U.dtype, device=U.device)
    A_el = phi[..., :, None] * (eye - _outer(Wp, Up))
    b_el = phi[..., :, None] * _outer(Wp, Yp)
    x0 = None
    if comm.size(group) > 1:
        x0 = _affine_in(*pe.mat_affine_total(A_el, b_el), group)
    F = pe.mat_affine_prefix(A_el, b_el, x0=x0)
    return Y - (U[..., :, None] * F).sum(-2), F


@_no_gradient
def sharded_solve_lower(t, c, U, W, y, *, group=None):
    """``z = L^{-1} y`` on sequence shards (vector or matrix right-hand
    side)."""
    Y, is_vec = _rhs(y, c.shape[0])
    Z, _ = _solve_lower(t, c, U, W, Y, group)
    return Z[..., 0] if is_vec else Z


@_no_gradient
def sharded_solve_upper(t, c, U, W, y, *, group=None):
    """``z = L^{-T} y`` on sequence shards (vector or matrix right-hand
    side): ``F_r = phi_r (I - u_{r+1} w_{r+1}^T) F_{r+1} + phi_r u_{r+1}
    y_{r+1}`` from the last row down."""
    C, B, J = U.shape
    Y, is_vec = _rhs(y, C)
    t_out, U_out, W_out, Y_out = comm.from_right(
        t.expand(C, B)[:, 0], U[:, 0], W[:, 0], Y[:, 0], group=group)
    phi = _transport_up(t, c, t_out, group)
    Un = torch.cat([U[:, 1:], U_out[:, None]], 1)
    Wn = torch.cat([W[:, 1:], W_out[:, None]], 1)
    Yn = torch.cat([Y[:, 1:], Y_out[:, None]], 1)
    eye = torch.eye(J, dtype=U.dtype, device=U.device)
    A_el = phi[..., :, None] * (eye - _outer(Un, Wn))
    b_el = phi[..., :, None] * _outer(Un, Yn)
    x0 = None
    if comm.size(group) > 1:
        x0 = _affine_in(*pe.mat_affine_total(A_el, b_el, reverse=True), group,
                        later_first=True)
    F = pe.mat_affine_prefix(A_el, b_el, reverse=True, x0=x0)
    Z = Y - (W[..., :, None] * F).sum(-2)
    return Z[..., 0] if is_vec else Z


# ============================================================== matmuls


def _diag_carry(F, decay, tot_a, tot_b, group, later_first):
    """``F (C, B, J, K)``, the diagonal-affine prefix from zero, plus the
    incoming carry: the ranks' total maps ``(tot_a (C, J), tot_b (C, J,
    K))`` before this one (``later_first``: after it) composed, applied to
    zero, and carried to each row by ``decay (C, B, J)``."""
    if comm.size(group) == 1:
        return F
    g = comm.all_gather(torch.cat([tot_a[..., None], tot_b], -1), group)
    acc = _fold((g[..., :1], g[..., 1:]), comm.index(group),
                lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]), later_first)
    return F if acc is None else F + decay[..., None] * acc[1][:, None]


def _cumulative(t, c, G, group, upper, transported=False):
    """The transported inclusive cumulative of ``G (C, B, J, K)`` over the
    global rows, ``F_r = phi_r F_prev + G_r`` (``upper``: from the last row
    down), on this rank's rows; with ``transported``, ``phi_r G_r`` in place
    of ``G_r``."""
    C, B = G.shape[:2]
    tt = t.expand(C, B)
    # the map of all this rank's rows is (the telescoped transport over them,
    # F at the row the walk ends on); the first rank's in walk order is only
    # ever applied to zero
    if upper:
        (t_out,) = comm.from_right(tt[:, 0], group=group)
        phi = _transport_up(t, c, t_out, group)
        G = phi[..., None] * G if transported else G
        F = scan.affine_prefix(phi.contiguous(), G.contiguous(), reverse=True)
        decay = torch.exp(-c[:, None, :] * (t_out[:, None] - tt)[..., None])
        return _diag_carry(F, decay, decay[:, 0], F[:, 0], group, True)
    (t_in,) = comm.from_left(tt[:, -1], group=group)
    phi, _ = _transport(t, c, t_in, group)
    G = phi[..., None] * G if transported else G
    F = scan.affine_prefix(phi.contiguous(), G.contiguous())
    decay = torch.exp(-c[:, None, :] * (tt - t_in[:, None])[..., None])
    return _diag_carry(F, decay, decay[:, -1], F[:, -1], group, False)


def _matmul(t, c, A, Bm, Y, group, upper):
    """The strict matmul ``sum_{r' < r (upper: >)} A_r . diag(transport)
    Bm_{r'} Y_{r'}`` on ``Y (C, B, K)``."""
    G = Bm[..., :, None] * Y[..., None, :]
    G = comm.next_rows(G, group) if upper else comm.prev_rows(G, group)
    F = _cumulative(t, c, G, group, upper, transported=True)
    return (A[..., :, None] * F).sum(-2)


@_no_gradient
def sharded_matmul_lower(t, c, U, V, y, *, group=None):
    """``tril_strict(U V^T (x) transport) @ y`` on sequence shards."""
    Y, is_vec = _rhs(y, c.shape[0])
    Z = _matmul(t, c, U, V, Y, group, False)
    return Z[..., 0] if is_vec else Z


@_no_gradient
def sharded_matmul_upper(t, c, U, V, y, *, group=None):
    """``triu_strict(V U^T (x) transport) @ y`` on sequence shards."""
    Y, is_vec = _rhs(y, c.shape[0])
    Z = _matmul(t, c, V, U, Y, group, True)
    return Z[..., 0] if is_vec else Z


@_no_gradient
def sharded_apply_inverse(t, c, U, W, d, y, *, group=None):
    """``K^{-1} y = L^{-T} d^{-1} L^{-1} y`` on sequence shards (vector or
    matrix right-hand side)."""
    Y, is_vec = _rhs(y, c.shape[0])
    Z, _ = _solve_lower(t, c, U, W, Y, group)
    Z = sharded_solve_upper(t, c, U, W, Z / _safe(d)[..., None], group=group)
    return Z[..., 0] if is_vec else Z


@_no_gradient
def sharded_dot_tril(t, c, U, W, d, y, *, group=None):
    """``L sqrt(d) y`` (the prior sampling weight) on sequence shards."""
    Y, is_vec = _rhs(y, c.shape[0])
    Z = torch.sqrt(torch.where(d > 0, d, torch.zeros_like(d)))[..., None] * Y
    Z = Z + _matmul(t, c, U, W, Z, group, False)
    return Z[..., 0] if is_vec else Z


# ====================================================== the log-likelihood


def _loglik_forward(t, c, a, U, V, resid, group):
    C, B, J = U.shape
    d, W, S, phi, dt, _ = _factor(t, c, a, U, V, group)
    Z, F = _solve_lower(t, c, U, W, resid[..., None], group)
    z = Z[..., 0]
    ok = _all_ok(d, group)
    # the forward's caches in the scan tier's conventions: S_half_r =
    # phi_r (.) (S_{r-1} + d_{r-1} w_{r-1} w_{r-1}^T), F_pre_r = F_{r-1} +
    # w_{r-1} z_{r-1}; row 0 from the left neighbour (zeros on the first
    # rank, whose phi_0 is zero)
    S_in, d_in, W_in, z_in, F_in = comm.from_left(
        S[:, -1], d[:, -1], W[:, -1], z[:, -1], F[:, -1, :, 0], group=group)
    S_prev = torch.cat([S_in[:, None], S[:, :-1]], 1)
    d_prev = torch.cat([d_in[:, None], d[:, :-1]], 1)
    W_prev = torch.cat([W_in[:, None], W[:, :-1]], 1)
    z_prev = torch.cat([z_in[:, None], z[:, :-1]], 1)
    F_prev = torch.cat([F_in[:, None], F[:, :-1, :, 0]], 1)
    S_half = phi[..., :, None] * (S_prev + d_prev[..., None, None] * _outer(W_prev, W_prev))
    F_pre = F_prev + W_prev * z_prev[..., None]
    # a chain that is not positive definite gives -inf and zero gradients:
    # its rows leave the sums before they enter them
    okr = ok[:, None]
    safe_d = torch.where(okr, _safe(d), torch.ones_like(d))
    z = torch.where(okr, z, torch.zeros_like(z))
    sums = comm.psum(torch.stack([torch.log(safe_d).sum(-1), (z * z / safe_d).sum(-1),
                                  torch.full_like(d[:, 0], B)], -1), group)
    ll = -0.5 * (sums[:, 0] + sums[:, 1] + sums[:, 2] * LOG2PI)
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    return ll, (U, W, safe_d, z, S_half, F_pre, phi, dt, W_prev, z_prev, ok)


# entries of the paired flow's dense step maps built at a time: the
# push-through of the basis keeps a few temporaries of this size
PAIR_CHUNK = 1 << 24


def _pair_elements(par, dim):
    """``assoc.pair_dense_elements`` of the ``(C, B, ...)`` step data, a
    slice of rows at a time into ``L (C, B, D, D)`` and ``c (C, B, D)``, so
    that its temporaries stay near ``PAIR_CHUNK`` entries whatever C B."""
    C, B = par[0].shape[:2]
    L = par[0].new_empty(C, B, dim, dim)
    c = par[0].new_empty(C, B, dim)
    step = max(1, PAIR_CHUNK // (C * dim * dim))
    for lo in range(0, B, step):
        rows = slice(lo, lo + step)
        L[:, rows], c[:, rows] = assoc.pair_dense_elements(
            tuple(x[:, rows] for x in par), dim)
    return L, c


def pair_flow(saved, bll):
    """The paired reverse flow of this rank's rows, from the forward's
    caches ``saved`` and the cotangent ``bll (C,)``: its dense step maps
    ``(L (C, B, D, D), c (C, B, D, 1))``, D = J^2 + 2J + 1, and the
    cotangents ``(bz, bW, bd, 1 / d)`` that the row outputs read."""
    U, W, safe_d, z, _, _, phi, _, W_prev, z_prev, ok = saved
    scale = torch.where(ok, bll, torch.zeros_like(bll))[:, None]
    dinv = 1.0 / safe_d
    bd_s = -0.5 * scale * (dinv - (z * dinv) ** 2)
    bz_cot = -scale * z * dinv
    zW = torch.zeros_like(W)
    par = (phi, U, W, W_prev, z_prev, bz_cot, zW, bd_s, dinv)
    Lmat, cvec = _pair_elements(par, assoc.pair_dim(U.shape[-1]))
    return Lmat, cvec[..., None], (bz_cot, zW, bd_s, dinv)


def _loglik_backward(c, saved, bll, group):
    """The hand-derived adjoint (JAX ``_sharded_loglik_bwd``): the paired
    solve and factor reverse flow, D = J^2 + 2J + 1, densified a step a row
    (``assoc.pair_dense_elements``) and run as a reverse matrix-affine
    prefix from the state entering this rank from the ranks after it (their
    total maps all-gathered); then every row's outputs.  Returns ``(bt (C,
    B), bc (C, J), ba, bU, bV, bresid)``, this rank's shares."""
    U, W, safe_d, z, S_half, F_pre, phi, dt, W_prev, z_prev, ok = saved
    Lmat, cvec, (bz_cot, zW, bd_s, dinv) = pair_flow(saved, bll)
    x0 = None
    if comm.size(group) > 1:
        x0 = _affine_in(*pe.mat_affine_total(Lmat, cvec, reverse=True), group,
                        later_first=True)
    x_aft = pe.mat_affine_prefix(Lmat, cvec, reverse=True, x0=x0)[..., 0]
    del Lmat, cvec
    x_last = torch.zeros_like(x_aft[:, :1]) if x0 is None else x0[:, None, :, 0]
    x_in = torch.cat([x_aft[:, 1:], x_last], 1)
    bz, bU, bV, ba, bp = assoc.pair_row_outputs(
        x_in, phi, U, W, F_pre, S_half, bz_cot, zW, bd_s, dinv)
    bc = (bp * (-dt)[..., None]).sum(1)
    ft = (bp * c[:, None, :]).sum(-1)
    (ft_next,) = comm.from_right(ft[:, 0], group=group)
    bt = torch.cat([ft[:, 1:], ft_next[:, None]], 1) - ft
    okc = ok[:, None]
    zero = lambda x: torch.where(okc.view(-1, *(1,) * (x.dim() - 1)), x,  # noqa: E731
                                 torch.zeros_like(x))
    return tuple(map(zero, (bt, bc, ba, bU, bV, bz)))


class ShardedLoglik(torch.autograd.Function):
    """The sharded log-likelihood with its hand-derived gradient."""

    @staticmethod
    def forward(ctx, t, c, a, U, V, resid, group):
        ll, saved = _loglik_forward(t, c, a, U, V, resid, group)
        ctx.save_for_backward(c, *saved)
        ctx.group = group
        ctx.t_shape, ctx.r_shape = t.shape, resid.shape
        return ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, bll):
        c, *saved = ctx.saved_tensors
        bt, bc, ba, bU, bV, br = _loglik_backward(c, saved, bll, ctx.group)
        if len(ctx.t_shape) == 1:
            bt = bt.sum(0)
        if len(ctx.r_shape) == 1:
            br = br.sum(0)
        return bt, bc, ba, bU, bV, br, None


def sharded_loglik(t, c, a, U, V, resid, *, group=None):
    """The GP log-likelihood of C chains with the sequence split over the
    ranks of ``group``: this rank's rows ``t (B,)``, ``a (C, B)``, ``U, V
    (C, B, J)``, ``resid (B,)`` or ``(C, B)`` (global N the ranks' B
    summed) and the shared ``c (C, J)``.  Returns the replicated ``(C,)``;
    a chain that is not positive definite on any rank gives -inf on every
    rank and zero gradients.  Its gradient is the hand-derived adjoint,
    this rank's share for a replicated input (see the module docstring)."""
    if U.dim() != 3:
        raise ValueError(f"U must be (C, B, J), got {tuple(U.shape)}")
    C, B, J = U.shape
    resid = resid.expand(C, B) if resid.dim() == 1 else resid
    return ShardedLoglik.apply(t, c, a.contiguous(), U.contiguous(), V.contiguous(),
                               resid, group)


# =========================================================== predictions


@_no_gradient
def sharded_conditional_variance(t, c, a, U, V, KxsT, k0, *, group=None):
    """The conditional predictive variance with the length-N axis sharded:
    ``var_m = k0 - sum_n KxsT[n, m] (K^{-1} KxsT)[n, m]``, the M solves
    through the matrix right-hand-side sharded ops and one psum.  ``KxsT
    (B, M)`` or ``(C, B, M)``: this rank's rows of the N x M
    cross-covariance; ``k0`` the prior variance at the targets.  Returns
    the replicated ``(C, M)``."""
    C = c.shape[0]
    KxsT = KxsT.expand(C, *KxsT.shape[-2:])
    d, W, *_ = _factor(t, c, a, U, V, group)
    X = sharded_apply_inverse(t, c, U, W, d, KxsT, group=group)
    k0 = torch.as_tensor(k0, dtype=KxsT.dtype, device=KxsT.device)
    return k0.reshape(-1, 1) - comm.psum((KxsT * X).sum(-2), group)


@_no_gradient
def sharded_conditional_covariance(t, c, a, U, V, KxsT, Kss, *, group=None):
    """The full conditional predictive covariance with the length-N axis
    sharded: ``Kss - sum_n KxsT[n, :] (K^{-1} KxsT)[n, :]^T``, one psum of
    the rank-B contractions.  Returns the replicated ``(C, M, M)``."""
    C = c.shape[0]
    KxsT = KxsT.expand(C, *KxsT.shape[-2:])
    d, W, *_ = _factor(t, c, a, U, V, group)
    X = sharded_apply_inverse(t, c, U, W, d, KxsT, group=group)
    return Kss - comm.psum(KxsT.mT @ X, group)


def _general_matmul(t1, t2, c, U1, V2, Y, group, upper):
    """The rectangular product with the SOURCE axis sharded: this rank's
    share of ``Z[n]`` (the sources it owns for target n: the last source
    at or before ``t1[n]`` in the global order, or with ``upper`` the first
    after it), psummed."""
    C, B, J = V2.shape
    Yk, is_vec = _rhs(Y, C)
    F = _cumulative(t2, c, V2[..., :, None] * Yk[..., None, :], group, upper)
    idx = torch.searchsorted(t2.contiguous(), t1.contiguous(), right=True)
    if upper:
        (t_edge,) = comm.from_left(t2[-1:], group=group)
        if comm.index(group) == 0:
            t_edge = torch.full_like(t_edge, -math.inf)
        own = (idx < B) & (t1 >= t_edge)
    else:
        (t_edge,) = comm.from_right(t2[:1], group=group)
        if comm.index(group) == comm.size(group) - 1:
            t_edge = torch.full_like(t_edge, math.inf)
        idx = idx - 1
        own = (idx >= 0) & (t1 < t_edge)
    rows = (C, t1.shape[-1])
    Z = _gathered_product(t1.expand(rows), t2.expand(C, B), c, U1, F, idx.expand(rows),
                          own.expand(rows), -1.0 if upper else 1.0)
    Z = comm.psum(Z, group)
    return Z[..., 0] if is_vec else Z


@_no_gradient
def sharded_general_matmul_lower(t1, t2, c, U1, V2, Y, *, group=None):
    """``Z[n] = sum_{m: t2[m] <= t1[n]} U1[n] . diag(e^{-c (t1[n] - t2[m])})
    V2[m] Y[m]`` with the source axis sharded: ``t1 (M,)``, ``U1 (C, M,
    J)`` the replicated targets, ``t2 (B,)``, ``V2 (C, B, J)``, ``Y`` this
    rank's sources.  Returns the replicated ``(C, M)`` (``(C, M, K)``)."""
    return _general_matmul(t1, t2, c, U1, V2, Y, group, False)


@_no_gradient
def sharded_general_matmul_upper(t1, t2, c, U1, V2, Y, *, group=None):
    """The upper counterpart: sources strictly after each target."""
    return _general_matmul(t1, t2, c, U1, V2, Y, group, True)


@_no_gradient
def sharded_predict_mean_at(t, c, a, U, V, resid, t_new, U_new, V_new, *,
                            group=None):
    """The conditional mean at new (replicated) points with the training
    axis sharded, ``K*(t_new, t) K^{-1} resid`` through the sharded general
    matmuls.  Returns the replicated ``(C, M)``."""
    d, W, *_ = _factor(t, c, a, U, V, group)
    alpha = sharded_apply_inverse(t, c, U, W, d, resid, group=group)
    return (_general_matmul(t_new, t, c, U_new, V, alpha, group, False)
            + _general_matmul(t_new, t, c, V_new, U, alpha, group, True))


@_no_gradient
def sharded_predict_mean(t, c, a, U, V, diag, resid, *, group=None):
    """The conditional mean at the training points on sequence shards:
    ``resid - diag K^{-1} resid`` (this rank's rows)."""
    d, W, *_ = _factor(t, c, a, U, V, group)
    resid = resid.expand(c.shape[0], t.shape[-1])
    return resid - diag * sharded_apply_inverse(t, c, U, W, d, resid, group=group)


# ============================================================ the entry points


def _local(x, sl, device, dtype):
    return torch.as_tensor(np.array(np.asarray(x)[sl]), dtype=dtype, device=device)


def _chains(kernel, t, diag):
    """``(c, a, U, V)`` of ``kernel`` at ``t`` with a leading chain axis
    (one chain for a kernel without one), and whether it had one."""
    c, a, U, V = kernel.get_celerite_matrices(t, diag)
    batched = c.dim() == 2
    if not batched:
        c, a, U, V = c[None], a[None], U[None], V[None]
    return c, a, U, V, batched


def make_sharded_logdensity(kernel_builder, t, y, yerr, mesh=None, *, device=None,
                            dtype=torch.float64):
    """``logdensity(theta)`` whose data axis is split over the mesh's ``seq``
    group (``mesh`` None: one shard): ``kernel_builder(theta) -> Term``;
    ``t, y, yerr`` the global arrays (their length divides over the ranks),
    of which this rank keeps its rows on ``device`` (default the package's
    ``Config.device``).  ``theta`` is ``(dim,)``, giving a scalar, or
    ``(C, dim)`` for a kernel with a chain axis, giving ``(C,)``; the value
    is replicated, and so is its gradient: ``theta`` goes through
    ``comm.varying``."""
    group = None if mesh is None else mesh.seq_group
    device = resolve_device(device)
    N = np.asarray(t).shape[0]
    sl = seq_sharding(mesh, N)
    t_l = _local(t, sl, device, dtype)
    y_l = _local(y, sl, device, dtype)
    var_l = _local(np.broadcast_to(np.asarray(yerr), (N,)), sl, device, dtype) ** 2

    def logdensity(theta):
        theta = comm.varying(theta, group)
        c, a, U, V, batched = _chains(kernel_builder(theta), t_l, var_l)
        ll = sharded_loglik(t_l, c, a, U, V, y_l, group=group)
        return ll if batched else ll[0]

    return logdensity


@_no_gradient
def sharded_sample_conditional(t, c, a, U, V, resid, diag, t_u, a_u, U_u, V_u,
                               pos_train, pos_test, t_new, U_new, V_new, z_u, eps,
                               *, group=None):
    """Exact conditional draws with the sequence sharded, by pathwise
    (Matheron) conditioning (no dense M x M Cholesky)::

        f* | y  =  f*  +  K(t_new, t) (K_tt + S)^{-1} (resid - f_t - e)

    with ``(f_t, f*)`` one draw of the joint latent prior over the sorted
    union of training and target times (the sharded factor and
    ``dot_tril``) and ``e = sqrt(diag) eps``.

    This rank's: the training rows ``t, a, U, V, resid, diag``, the union's
    rows ``t_u, a_u, U_u, V_u``, their normals ``z_u (C, B_u, K)``,
    ``eps (C, B, K)``, and ``pos_train`` (its training points' positions in
    the global union).  Replicated: ``c``, ``pos_test (M,)``, the targets'
    ``t_new``, ``U_new``, ``V_new``.  Every rank holds as many union rows
    (the union is padded past its end: later rows never reach earlier
    ones).  One all_gather of the latent draw, O(N + M) values.  Returns the
    replicated ``(C, M, K)`` (the mean not included)."""
    C = c.shape[0]
    d_u, W_u, *_ = _factor(t_u, c, a_u, U_u, V_u, group)
    f_u = sharded_dot_tril(t_u, c, U_u, W_u, d_u, z_u, group=group)
    f = comm.all_gather(f_u, group)  # (ranks, C, B_u, K)
    f = f.permute(1, 0, 2, 3).reshape(C, -1, f.shape[-1])
    r = resid.expand(C, t.shape[-1])[..., None] - f[:, pos_train] \
        - torch.sqrt(diag)[..., None] * eps
    d, W, *_ = _factor(t, c, a, U, V, group)
    alpha = sharded_apply_inverse(t, c, U, W, d, r, group=group)
    corr = (_general_matmul(t_new, t, c, U_new, V, alpha, group, False)
            + _general_matmul(t_new, t, c, V_new, U, alpha, group, True))
    return f[:, pos_test] + corr


def make_sharded_conditional_sampler(kernel, t, y, yerr, t_new, mesh=None, *,
                                     mean=0.0, regularize=None, device=None,
                                     dtype=torch.float64):
    """``sample(generator, shape=()) -> (*shape, M)``: exact conditional
    draws at ``t_new`` with the sequence split over the mesh's ``seq`` group
    (pathwise conditioning, :func:`sharded_sample_conditional`).

    Host-side set-up: the sorted union of ``t`` and ``t_new``, padded past
    its end to divide over the ranks, and where each point lands in it.
    ``len(t)`` itself divides over the ranks.  ``regularize`` jitters the
    joint prior's diagonal (ROADMAP C8), as ``gp_sample_conditional`` does.
    Every rank draws the whole normals from ``generator`` (a
    ``torch.Generator`` seeded alike on every rank) in the order of
    ``gp_sample_conditional`` (the joint prior's ``(*shape, N + M)``, then
    the noise's ``(*shape, N)``) and keeps its rows, so the draws do not
    depend on the layout: one rank gives ``gp_sample_conditional``'s."""
    group = None if mesh is None else mesh.seq_group
    n = comm.size(group)
    device = resolve_device(device)
    t, y, t_new = (np.asarray(x, dtype=np.float64) for x in (t, y, t_new))
    yerr = np.broadcast_to(np.asarray(yerr, dtype=np.float64), t.shape)
    N, M = t.shape[0], t_new.shape[0]
    t_all = np.concatenate([t, t_new])
    order = np.argsort(t_all, kind="stable")
    t_u = t_all[order]
    inv = np.argsort(order, kind="stable")
    pad = (-(N + M)) % n
    if pad:
        step = np.median(np.diff(t_u)) if N + M > 1 else 1.0
        t_u = np.concatenate([t_u, t_u[-1] + step * np.arange(1, pad + 1)])
    sl, sl_u = seq_sharding(mesh, N), seq_sharding(mesh, t_u.shape[0])

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    t_l, tu_l, t_nw = tensor(t[sl]), tensor(t_u[sl_u]), tensor(t_new)
    diag_l = tensor(yerr[sl] ** 2)
    diag_u = torch.zeros_like(tu_l) + (0.0 if regularize is None else regularize)
    c, a, U, V, batched = _chains(kernel, t_l, diag_l)
    if batched:
        raise ValueError("make_sharded_conditional_sampler: one system (a kernel "
                         "without a chain axis)")
    _, a_u, U_u, V_u, _ = _chains(kernel, tu_l, diag_u)
    _, _, U_new, V_new, _ = _chains(kernel, t_nw, torch.zeros_like(t_nw))
    mean_fn = mean if callable(mean) else (lambda x: torch.full_like(x, float(mean)))
    resid = tensor(y[sl]) - mean_fn(t_l)
    mean_new = mean_fn(t_nw)
    pos_train = torch.as_tensor(inv[:N][sl], device=device)
    pos_test = torch.as_tensor(inv[N:], device=device)

    def sample(generator, shape=()):
        shape = tuple(shape)
        S = int(np.prod(shape))
        gdev = generator.device
        z = torch.randn(shape + (N + M,), generator=generator, dtype=dtype,
                        device=gdev).reshape(S, N + M)
        eps = torch.randn(shape + (N,), generator=generator, dtype=dtype,
                          device=gdev).reshape(S, N)
        z = torch.cat([z, z.new_zeros(S, pad)], 1)[:, sl_u].to(device)
        eps = eps[:, sl].to(device)
        draw = sharded_sample_conditional(
            t_l, c, a, U, V, resid, diag_l, tu_l, a_u, U_u, V_u, pos_train,
            pos_test, t_nw, U_new, V_new, z.mT[None], eps.mT[None], group=group)
        return (draw[0].mT + mean_new).reshape(*shape, M)

    return sample
