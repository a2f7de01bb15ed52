"""The fused GP log-likelihood: value and gradient as three scan passes.

Counterpart of ``celerite2_tpu/ops/fused_slab.py`` (``loglik_slab`` with
its ``_forward`` and ``_backward``), on natural ``(C, N)`` layout with a
leading chain axis, for J = 1..4.  The three sequential flows of the
value+gradient

  1. the Kalman-element forward (Cholesky factor + lower solve in one
     pass),
  2. the solve adjoint (suffix composition of J-affine maps),
  3. the factor adjoint (suffix composition of J^2-affine maps),

each run as a two-level scan over blocks of rows.

Each pass returns the per-row states the glue uses: S and F of the
forward (K1), the solve adjoint's Rst (K2), the factor adjoint's MX (K3 at
J <= 2; K4 and K5 at J = 3, 4).  On the card each is a CUDA kernel family
(``csrc/fused_loglik.cu``) that runs the whole scan, its cross-block level
included, in blocks of rows of its own choosing
(``_build.fused_block_len``, ``_build.factor_adjoint_block_len``,
``_build.structured_block_len``).  Their
plain versions, below, run it in PyTorch in blocks of L rows:

* within each block, the pass builds every row's element from the raw
  per-row data, composes the elements in order and emits per-row
  prefixes and one map per block;
* the cross-block level composes the ``C x NB`` block maps with a
  Hillis-Steele prefix (``ops/elements.py``), and the distribute
  combines each row's prefix with its block's exclusive state.

At J = 3, 4 the factor adjoint instead takes the JAX package's
structured route (``_factor_adjoint_structured``): a dense J^2-affine
element per row is J^4 + J^2 values, so only per-block maps are
densified and composed within groups of ``_build.FUSED_GROUP`` blocks
(K4), the state is carried over the groups (phase B), and each block is
re-run from its incoming state (K5).  Their plain versions keep the
kernels' order: each group's maps composed from its last block to its
first, then the groups.

The glue that turns the states into d, W, Z, the log-likelihood and the
six cotangents is shared by the CUDA and CPU routes.

Fidelity to the JAX package: non-PD rows divide by 1 (``ainv``,
``safe_dd``); ``ll`` is ``-inf`` per chain when the system is not
positive definite, and the cotangents are then zero.
"""

from __future__ import annotations

import math

import torch

from celerite2_torch.ops import _build
from celerite2_torch.ops import elements as el

__all__ = [
    "LAUNCHES",
    "LoglikFused",
    "default_block_len",
    "loglik_fused",
    "pass_inputs",
    "kalman_fwd",
    "kalman_fwd_plain",
    "solve_rev",
    "solve_rev_plain",
    "factor_rev",
    "factor_rev_blocks",
    "factor_rev_plain",
    "frev_block_maps",
    "frev_maps",
    "frev_maps_plain",
    "frev_seeds",
    "frev_states",
    "frev_states_plain",
    "factor_adjoint",
]

LOG2PI = math.log(2.0 * math.pi)
LAUNCHES = _build.LAUNCHES


def default_block_len(N: int) -> int:
    """Rows per block L of the plain versions.  The kernels take their own
    on the card (``_build.fused_block_len``,
    ``_build.factor_adjoint_block_len``, ``_build.structured_block_len``)."""
    return max(1, min(N, 256))


# ================================================================ layout
#
# Per-row prefixes and block maps are flat on their last axis:
#   Kalman  E = 3J^2 + 2J:  A, Q, R (row-major J x J), b (J), eta (J)
#   affine  E = D^2 + D:    A (row-major D x D), b (D)


def _kalman_unflat(x, J):
    s = x.shape[:-1]
    JJ = J * J
    return (
        x[..., :JJ].reshape(*s, J, J),
        x[..., JJ : 2 * JJ].reshape(*s, J, J),
        x[..., 2 * JJ : 3 * JJ].reshape(*s, J, J),
        x[..., 3 * JJ : 3 * JJ + J].reshape(*s, J, 1),
        x[..., 3 * JJ + J :].reshape(*s, J, 1),
    )


def _affine_unflat(x, D):
    s = x.shape[:-1]
    return x[..., : D * D].reshape(*s, D, D), x[..., D * D :].reshape(*s, D, 1)


def _flat(element):
    return torch.cat([m.flatten(-2) for m in element], -1)


def _shift_bwd(x):
    """Row n receives row n-1's value (row 0 gets 0), per chain."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def _shift_fwd(x):
    """Row n receives row n+1's value (row N-1 gets 0), per chain."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)


def _blocks(x, L, fill):
    """(C, N, ...) -> (C, NB, L, ...), padding the ragged end with fill."""
    C, N = x.shape[:2]
    NB = -(-N // L)
    pad = NB * L - N
    if pad:
        x = torch.cat([x, x.new_full((C, pad) + x.shape[2:], fill)], 1)
    return x.reshape(C, NB, L, *x.shape[2:])


def _row0_zeroed(U):
    """U with row 0 of every chain zeroed: the reverse flows' step n
    uses row n's own u, and step 0 does not exist (identity element)."""
    return torch.cat([torch.zeros_like(U[:, :1]), U[:, 1:]], 1)


def _plain_scan(steps, N, L, combine, identity, E, reverse):
    """Within-block scan of the plain versions: ``steps(l)`` gives the
    (C, NB)-batched element of step l; rows past N keep the running
    value (as the kernels skip them)."""
    NB = -(-N // L)
    device = identity[0].device
    valid = (torch.arange(NB * L, device=device) < N).reshape(NB, L)
    acc = identity
    pre = []
    order = range(L - 1, -1, -1) if reverse else range(L)
    for l in order:
        new = combine(acc, steps(l))
        acc = tuple(
            torch.where(valid[:, l].reshape(NB, *[1] * (a.dim() - 2)), n, a)
            for n, a in zip(new, acc)
        )
        pre.append(_flat(acc))
    if reverse:
        pre.reverse()
    C = acc[0].shape[0]
    rows = torch.stack(pre, 2).reshape(C, NB * L, E)[:, :N]
    return rows.contiguous(), _flat(acc)


# ===================================================== K1: forward pass


def kalman_fwd_plain(p, U, V, ainv, y, L):
    """Plain version of K1: for each row, the Kalman element built from
    p = exp(-c dt) and the previous row's (u, v, 1/a, y), composed
    forward within each block of L rows, then across the blocks.
    Returns the state after every row, ``S (C, N, J, J)`` (the carry
    covariance) and ``F (C, N, J)`` (the solve state)."""
    C, N, J = U.shape
    pb = _blocks(p, L, 1.0)
    upb = _blocks(_shift_bwd(U), L, 0.0)
    vpb = _blocks(_shift_bwd(V), L, 0.0)
    aib = _blocks(_shift_bwd(ainv), L, 0.0)
    ypb = _blocks(_shift_bwd(y), L, 0.0)
    eye = torch.eye(J, dtype=p.dtype, device=p.device)

    def steps(l):  # fused_slab._build_kalman
        pr, up, vp = pb[:, :, l], upb[:, :, l], vpb[:, :, l]
        ai = aib[:, :, l][..., None, None]
        yp = ypb[:, :, l][..., None, None]
        A = pr[..., :, None] * (eye - vp[..., :, None] * up[..., None, :] * ai)
        Q = (pr * vp)[..., :, None] * (vp * pr)[..., None, :] * ai
        R = -up[..., :, None] * up[..., None, :] * ai
        b = (pr * vp)[..., :, None] * yp * ai
        eta = -up[..., :, None] * yp * ai
        return (A, Q, R, b, eta)

    NB = pb.shape[1]
    ident = el.kalman_identity((C, NB), J, dtype=p.dtype, device=p.device)
    pre, maps = _plain_scan(
        steps, N, L, el.kalman_combine, ident, 3 * J * J + 2 * J, False
    )
    full = _complete(pre, maps, _KALMAN, J, L, reverse=False)
    return full[1], full[3][..., 0]


def kalman_fwd(p, U, V, ainv, y, L):
    """K1: the CUDA kernels for CUDA tensors (in blocks of their own
    length), the plain version in blocks of L rows on CPU."""
    if p.device.type == "cpu":
        return kalman_fwd_plain(p, U, V, ainv, y, L)
    return _build.kalman_fwd_cuda(p, U, V, ainv, y)


# =============================================== K2: solve adjoint pass


def solve_rev_plain(p, U, W, bz, L):
    """Plain version of K2: the affine maps A = diag(p)(I - u w^T),
    b = -p u bZ (u = 0 at row 0 of every chain), composed as suffixes
    within each block of L rows, then across the blocks.  Returns the
    suffix state of every row, ``Rst (C, N, J)``: Rst_n = A_n Rst_{n+1}
    + b_n from zero past the last row."""
    C, N, J = U.shape
    pb = _blocks(p, L, 1.0)
    ub = _blocks(_row0_zeroed(U), L, 0.0)
    wb = _blocks(W, L, 0.0)
    zb = _blocks(bz, L, 0.0)
    eye = torch.eye(J, dtype=p.dtype, device=p.device)

    def steps(l):  # fused_slab._build_solve_rev
        pr, u, w = pb[:, :, l], ub[:, :, l], wb[:, :, l]
        A = pr[..., :, None] * (eye - u[..., :, None] * w[..., None, :])
        b = (-pr * u * zb[:, :, l][..., None])[..., None]
        return (A, b)

    NB = pb.shape[1]
    ident = el.affine_identity((C, NB), J, dtype=p.dtype, device=p.device)
    pre, maps = _plain_scan(
        steps, N, L, el.affine_combine, ident, J * J + J, True
    )
    return _complete(pre, maps, _AFFINE, J, L, reverse=True)[1][..., 0]


def solve_rev(p, U, W, bz, L):
    """K2: the CUDA kernels for CUDA tensors (in blocks of their own
    length), the plain version in blocks of L rows on CPU."""
    if p.device.type == "cpu":
        return solve_rev_plain(p, U, W, bz, L)
    return _build.solve_rev_cuda(p, U, W, bz)


# ============================================== K3: factor adjoint pass


def _factor_rev_element(p, u, w, bv0, bdp):
    """The dense J^2-affine reverse-factor step (fused_slab.
    _build_factor_rev): linear part dM'[jk]/dM[lm] = p_j p_k [d_jl d_km
    - u_j (d_kl w_m + d_km w_l) + u_j u_k w_l w_m], constant part the
    step applied to M = 0.  Inputs (..., J) and bdp (...)."""
    J = p.shape[-1]
    eye = torch.eye(J, dtype=p.dtype, device=p.device)
    # index order [j, k, l, m] on the trailing four axes
    d_jl_km = eye[:, None, :, None] * eye[None, :, None, :]
    d_kl_wm = eye[None, :, :, None] * w[..., None, None, None, :]
    d_km_wl = eye[None, :, None, :] * w[..., None, None, :, None]
    uj = u[..., :, None, None, None]
    uk = u[..., None, :, None, None]
    wl = w[..., None, None, :, None]
    wm = w[..., None, None, None, :]
    val = d_jl_km - uj * (d_kl_wm + d_km_wl) + uj * uk * wl * wm
    pp = p[..., :, None] * p[..., None, :]
    A = (pp[..., None, None] * val).reshape(*p.shape[:-1], J * J, J * J)
    const = (
        p[..., :, None]
        * (-u[..., :, None] * bv0[..., None, :]
           - bdp[..., None, None] * u[..., :, None] * u[..., None, :])
        * p[..., None, :]
    )
    return A, const.reshape(*p.shape[:-1], J * J, 1)


def factor_rev_blocks(p, U, W, bv0, bdp, L):
    """The within-block pass of the plain K3: the dense J^2-affine
    reverse-factor steps (u = 0 at row 0 of every chain), composed as
    suffixes within each block.  Returns per-row maps ``(C, N, J^4+J^2)``
    and block maps ``(C, NB, J^4+J^2)``."""
    C, N, J = U.shape
    D = J * J
    pb = _blocks(p, L, 1.0)
    ub = _blocks(_row0_zeroed(U), L, 0.0)
    wb = _blocks(W, L, 0.0)
    gb = _blocks(bv0, L, 0.0)
    db = _blocks(bdp, L, 0.0)

    def steps(l):
        return _factor_rev_element(
            pb[:, :, l], ub[:, :, l], wb[:, :, l], gb[:, :, l], db[:, :, l]
        )

    NB = pb.shape[1]
    ident = el.affine_identity((C, NB), D, dtype=p.dtype, device=p.device)
    return _plain_scan(steps, N, L, el.affine_combine, ident, D * D + D, True)


def factor_rev_plain(p, U, W, bv0, bdp, L):
    """Plain version of K3: the within-block pass
    (:func:`factor_rev_blocks`), the cross-block level and the distribute
    give the suffix state after every row, Mst; returns ``MX (C, N, J,
    J)``: the state entering row n (Mst of row n + 1) for n >= 1, and Mst
    of row 0, the state after every step."""
    C, N, J = U.shape
    pre, maps = factor_rev_blocks(p, U, W, bv0, bdp, L)
    Mst = _complete(pre, maps, _AFFINE, J * J, L, reverse=True)[1][..., 0]
    Mst = Mst.reshape(C, N, J, J)
    row0 = torch.arange(N, device=U.device) == 0
    return torch.where(row0[:, None, None], Mst, _shift_fwd(Mst))


def factor_rev(p, U, W, bv0, bdp, L):
    """K3: the CUDA kernels for CUDA tensors (in blocks of their own
    length), the plain version in blocks of L rows on CPU."""
    if p.device.type == "cpu":
        return factor_rev_plain(p, U, W, bv0, bdp, L)
    return _build.factor_rev_cuda(p, U, W, bv0, bdp)


# ============================= K4, K5: the structured factor adjoint
#
# fused_slab._factor_adjoint_structured: the reverse-factor step applied
# to a J x J state in O(J^2) (no dense J^2 x J^2 element per row).
#   K4 (phase A) densifies each block's composed map and composes each
#     group's maps (the part of phase B inside a group),
#   K5 carries the state over the groups (the rest of phase B), giving
#     each block's incoming state (its seed), and re-runs each block from
#     its seed (phase C), emitting the state entering every row.


def _structured_apply(M, par, affine):
    """One reverse-factor step on states ``M (..., K, J, J)`` with the
    row's parameters ``par`` (each ``(..., J)``, ``bdp (...)``), all K
    states at once; ``affine`` (bool ``(K,)``) marks the states that take
    the constant part (fused_slab._structured_apply):
    ``bv = (M + M^T) w (+bv0)``, ``ba = -w^T M w (+bdp)``,
    ``M' = p (.) [M - u (x) bv - ba u (x) u] (.) p``."""
    p, u, w, bv0 = (x[..., None, :] for x in par[:4])
    bdp = par[4][..., None]
    Mw = (M * w[..., None, :]).sum(-1)
    bv = Mw + (M * w[..., :, None]).sum(-2)
    ba = -(w * Mw).sum(-1)
    bv = torch.where(affine[:, None], bv + bv0, bv)
    ba = torch.where(affine, ba + bdp, ba)
    uu = u[..., :, None] * u[..., None, :]
    return (
        p[..., :, None]
        * (M - u[..., :, None] * bv[..., None, :] - ba[..., None, None] * uu)
        * p[..., None, :]
    )


def _frev_steps(p, U, W, bv0, bdp, L):
    """The blocked per-row parameters of the reverse-factor steps (u = 0
    at row 0 of every chain) and the validity of each blocked row."""
    N = U.shape[1]
    par = (
        _blocks(p, L, 1.0),
        _blocks(_row0_zeroed(U), L, 0.0),
        _blocks(W, L, 0.0),
        _blocks(bv0, L, 0.0),
        _blocks(bdp, L, 0.0),
    )
    NB = par[0].shape[1]
    valid = (torch.arange(NB * L, device=p.device) < N).reshape(NB, L)
    return par, valid


def frev_block_maps(p, U, W, bv0, bdp, L):
    """Each block's composed reverse-factor map: per (chain, block), the
    D = J^2 basis matrices through the linear part of the block's steps
    and the zero state through the affine steps, rows descending.
    Returns ``(C, NB, D^2+D)``: column k of the linear part at
    ``[k D, (k+1) D)``, the constant last (K4's block maps, as its walk
    leaves them)."""
    C, N, J = U.shape
    D = J * J
    par, valid = _frev_steps(p, U, W, bv0, bdp, L)
    NB = valid.shape[0]
    eye = torch.eye(D, dtype=p.dtype, device=p.device)
    basis = torch.cat([eye, torch.zeros_like(eye[:1])]).reshape(D + 1, J, J)
    M = basis.expand(C, NB, D + 1, J, J)
    affine = torch.arange(D + 1, device=p.device) == D
    for l in range(L - 1, -1, -1):
        new = _structured_apply(M, tuple(x[:, :, l] for x in par), affine)
        M = torch.where(valid[:, l, None, None, None], new, M)
    return M.reshape(C, NB, (D + 1) * D).contiguous()


def _affine_flat(cols):
    """Affine maps given by columns ``(..., D+1, D)`` (column k of the
    linear part, then the constant) as ``(..., D^2+D)``: the linear part
    row-major, then the constant (``AffineMaps``)."""
    D = cols.shape[-1]
    return torch.cat([cols[..., :D, :].mT.flatten(-2), cols[..., D, :]], -1)


def frev_maps_plain(p, U, W, bv0, bdp, L):
    """Plain version of K4: the block maps (:func:`frev_block_maps`)
    composed within groups of ``_build.FUSED_GROUP`` consecutive blocks
    from the last block to the first, as the kernel composes them: block
    b's suffix is its map after the suffix of block b + 1 of its group.
    Returns ``suffix (C, NB, D^2+D)`` and each group's map, its first
    block's suffix, ``groups (C, GB, D^2+D)``: the linear part
    row-major, then the constant."""
    C, N, J = U.shape
    D = J * J
    G = _build.FUSED_GROUP
    maps = frev_block_maps(p, U, W, bv0, bdp, L)
    NB = maps.shape[1]
    GB = -(-NB // G)
    cols = maps.reshape(C, NB, D + 1, D)
    cols = torch.cat([cols, cols.new_zeros(C, GB * G - NB, D + 1, D)], 1)
    cols = cols.reshape(C, GB, G, D + 1, D)
    valid = (torch.arange(GB * G, device=p.device) < NB).reshape(GB, G)
    eye = torch.eye(D, dtype=p.dtype, device=p.device)
    S = torch.cat([eye, torch.zeros_like(eye[:1])]).expand(C, GB, D + 1, D)
    out = [None] * G
    for g in range(G - 1, -1, -1):
        A_T = cols[:, :, g, :D, :]  # row j: column j of the block's A
        new = S @ A_T
        new[..., D, :] += cols[:, :, g, D, :]
        S = torch.where(valid[:, g, None, None], new, S)
        out[g] = S
    suffix = torch.stack(out, 2).reshape(C, GB * G, D + 1, D)[:, :NB]
    return _affine_flat(suffix).contiguous(), _affine_flat(out[0]).contiguous()


def frev_maps(p, U, W, bv0, bdp, L):
    """K4: the CUDA kernel for CUDA tensors (in blocks of its own length
    on the card; ``(None, None)`` with one block), the plain version in
    blocks of L rows on CPU.  Returns ``(suffix, groups)``."""
    if p.device.type == "cpu":
        return frev_maps_plain(p, U, W, bv0, bdp, L)
    return _build.frev_maps_cuda(p, U, W, bv0, bdp)


def frev_seeds(suffix, groups, J):
    """Phase B in K5's order: the state entering each group, zero for the
    last and the map of group g + 1 applied to the state entering it for
    the others (last to first), then carried through the suffix of the
    group's later blocks (``suffix (C, NB, J^4+J^2)``, ``groups (C, GB,
    J^4+J^2)``, :func:`frev_maps_plain`).  Returns the state entering each
    block, ``(C, NB, J^2)``."""
    C, NB = suffix.shape[:2]
    GB = groups.shape[1]
    D = J * J
    G = _build.FUSED_GROUP
    Ag, bg = _affine_unflat(groups, D)
    x = groups.new_zeros(C, D, 1)
    entering = [None] * GB
    for g in range(GB - 1, -1, -1):
        entering[g] = x
        if g:
            x = Ag[:, g] @ x + bg[:, g]
    blk = torch.arange(NB, device=suffix.device)
    x = torch.stack(entering, 1)[:, blk // G]  # (C, NB, D, 1)
    nxt = blk + 1
    inside = (nxt % G != 0) & (nxt < NB)
    As, bs = _affine_unflat(suffix[:, nxt.clamp(max=NB - 1)], D)
    carried = As @ x + bs
    return torch.where(inside[:, None, None], carried, x)[..., 0].contiguous()


def frev_states_plain(p, U, W, bv0, bdp, suffix, groups, L):
    """Plain version of K5: phase B (:func:`frev_seeds`) on K4's suffixes
    and group maps (None with one block: the state entering it is zero),
    then per (chain, block) the affine steps from the block's seed, rows
    descending, recording the state entering each row.  Returns
    ``MX (C, N, J, J)``."""
    C, N, J = U.shape
    D = J * J
    par, valid = _frev_steps(p, U, W, bv0, bdp, L)
    NB = valid.shape[0]
    if suffix is None:
        if NB > 1:
            raise ValueError("frev_states: more than one block needs K4's maps")
        seeds = p.new_zeros(C, 1, D)
    else:
        seeds = frev_seeds(suffix, groups, J)
    M = seeds.reshape(C, NB, 1, J, J)
    affine = torch.ones(1, dtype=torch.bool, device=p.device)
    rows = [None] * L
    for l in range(L - 1, -1, -1):
        rows[l] = M.reshape(C, NB, D)
        new = _structured_apply(M, tuple(x[:, :, l] for x in par), affine)
        M = torch.where(valid[:, l, None, None, None], new, M)
    out = torch.stack(rows, 2).reshape(C, NB * L, D)[:, :N].contiguous()
    return out.reshape(C, N, J, J)


def frev_states(p, U, W, bv0, bdp, suffix, groups, L):
    """K5: the CUDA kernels for CUDA tensors (in blocks of their own
    length, those of K4's ``suffix`` and ``groups``), the plain version
    in blocks of L rows on CPU."""
    if p.device.type == "cpu":
        return frev_states_plain(p, U, W, bv0, bdp, suffix, groups, L)
    return _build.frev_states_cuda(p, U, W, bv0, bdp, suffix, groups)


# ======================================= cross-block level + distribute


# (unflatten, combine, distribute, identity) of each element family
_KALMAN = (_kalman_unflat, el.kalman_combine, el.kalman_distribute,
           el.kalman_identity)
_AFFINE = (_affine_unflat, el.affine_combine, el.affine_distribute,
           el.affine_identity)


def _complete(pre, maps, family, width, L, reverse):
    """Per-row full states from the per-row prefixes and block maps."""
    unflat, combine, distribute, identity = family
    C, N = pre.shape[:2]
    NB = maps.shape[1]
    ident = identity((C, NB), width, dtype=maps.dtype, device=maps.device)
    excl = el.exclusive_block_states(
        unflat(maps, width), combine, ident, reverse=reverse
    )
    block_of_row = torch.arange(N, device=pre.device) // L
    excl_rows = tuple(e.index_select(1, block_of_row) for e in excl)
    return distribute(excl_rows, unflat(pre, width))


# ============================================================= pipeline


def _forward(t, c, a, U, V, y, L, record=None):
    """Forward: returns ``ll (C,)`` and what the backward needs.
    ``record`` (a dict) receives the pass's inputs."""
    C, N, J = U.shape
    a, U, V, y = (x.contiguous() for x in (a, U, V, y))
    dt = torch.diff(t, dim=-1, prepend=t[..., :1])  # dt = 0 at row 0
    dt = dt.expand(C, N)
    p = torch.exp(-c[:, None, :] * dt[..., None]).contiguous()
    # non-PD rows divide by 1 (quiet failure)
    ainv = 1.0 / torch.where(a > 0, a, torch.ones_like(a))

    if record is not None:
        record["kalman_fwd"] = (p, U, V, ainv, y)
    S, F = kalman_fwd(p, U, V, ainv, y, L)

    Su = (S @ U[..., None])[..., 0]
    dd = a - (U * Su).sum(-1)
    ok = (dd > 0).all(-1)
    safe_dd = torch.where(dd > 0, dd, torch.ones_like(dd))
    W = (V - Su) / safe_dd[..., None]
    Z = y - (U * F).sum(-1)

    ll = -0.5 * (
        torch.log(safe_dd).sum(-1) + (Z * Z / safe_dd).sum(-1) + N * LOG2PI
    )
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    return ll, (dt, p, U, W, S, F, dd, Z, ok)


def factor_adjoint(p, U, W, bv0, bdp, L, *, structured=None, record=None):
    """The reverse-factor state each row's formulas use, ``MX (C, N, J,
    J)``: the state entering step n for rows n >= 1, and the state after
    every step for row 0 (whose step is the identity).

    ``structured`` picks the route: the dense J^2-affine scan K3 (the
    default for J <= 2) or the structured K4 -> phase B -> K5 (the default
    for J = 3, 4), as ``fused_slab._backward`` routes.  Both compute the
    same affine recursion.  ``record`` (a dict) receives the kernels'
    inputs."""
    J = U.shape[-1]
    if structured is None:
        structured = J > 2
    if structured:
        if record is not None:
            record["frev_maps"] = (p, U, W, bv0, bdp)
        maps = frev_maps(p, U, W, bv0, bdp, L)
        if record is not None:
            record["frev_states"] = (p, U, W, bv0, bdp, *maps)
        return frev_states(p, U, W, bv0, bdp, *maps, L)
    if record is not None:
        record["factor_rev"] = (p, U, W, bv0, bdp)
    return factor_rev(p, U, W, bv0, bdp, L)


def _backward(c, saved, bll, L, record=None, structured=None):
    """Backward: the solve and factor adjoints as reverse scans; returns
    (bt, bc, ba, bU, bV, by) with bt per chain ``(C, N)``.  ``record`` (a
    dict) receives the passes' inputs; ``structured`` picks the factor
    adjoint's route (:func:`factor_adjoint`)."""
    dt, p, U, W, S, F, dd, Z, ok = saved
    C, N, J = U.shape
    zero = torch.zeros((), dtype=dd.dtype, device=dd.device)
    row0 = torch.arange(N, device=dd.device) == 0
    smask = ~row0  # rows n >= 1 (every row of natural layout is valid)

    okf = (ok.to(dd.dtype) * bll)[:, None]
    # a chain that is not positive definite takes d = 1 and Z = 0 before the
    # products (as gp.py does at J > 4): its float32 Z^2 d^-2 can overflow,
    # and okf's 0 times inf would be NaN
    okc = ok[:, None]
    dd = torch.where(okc & (dd > 0), dd, torch.ones_like(dd))
    Z = torch.where(okc, Z, torch.zeros_like(Z))
    dinv = 1.0 / dd
    bd = -0.5 * okf * (dinv - Z * Z * dinv * dinv)
    bZt = -okf * Z * dinv

    # ---------------- solve adjoint (K2) ------------------------------
    if record is not None:
        record["solve_rev"] = (p, U, W, bZt)
    Rst = solve_rev(p, U, W, bZt, L)

    W_prev = _shift_bwd(W)
    Z_prev = _shift_bwd(Z)
    F_pre = _shift_bwd(F) + W_prev * Z_prev[..., None]
    bF_in = _shift_fwd(Rst)
    bz_eff = bZt + (bF_in * W).sum(-1)
    mid = bF_in - U * bz_eff[..., None]
    post = p * mid
    sm = smask[:, None]
    bU1 = torch.where(sm, -p * F_pre * bz_eff[..., None], zero)
    bp1 = torch.where(sm, F_pre * mid * p, zero)
    dbR = (post * W_prev).sum(-1)
    dbB = post * Z_prev[..., None]
    bY = torch.where(row0, bZt + _shift_fwd(dbR), bz_eff)
    bW_tot = _shift_fwd(dbB)

    # ---------------- factor adjoint (K3, or K4 + K5) -----------------
    bv0 = bW_tot * dinv[..., None]
    bdp = bd - (W * bv0).sum(-1)
    MX = factor_adjoint(p, U, W, bv0, bdp, L, structured=structured,
                        record=record)
    bv = bv0 + ((MX + MX.mT) @ W[..., None])[..., 0]
    ba = bdp - (W * (MX @ W[..., None])[..., 0]).sum(-1)
    # S_half uses the previous row's d and W
    dd_prev = _shift_bwd(dd)
    S_half = p[..., :, None] * (
        _shift_bwd(S)
        + dd_prev[..., None, None] * W_prev[..., :, None] * W_prev[..., None, :]
    )
    bU2 = torch.where(
        sm,
        -(S_half @ (p * (bv + 2.0 * ba[..., None] * U))[..., None])[..., 0],
        zero,
    )
    mid3 = (
        MX
        - U[..., :, None] * bv[..., None, :]
        - ba[..., None, None] * U[..., :, None] * U[..., None, :]
    )
    bp2 = torch.where(
        sm,
        ((mid3 * S_half.mT).sum(-1) + (S_half * mid3).sum(-2)) * p,
        zero,
    )

    # ---------------- assemble cotangents -----------------------------
    bp = bp1 + bp2
    ft = (bp * c[:, None, :]).sum(-1)
    bt = -ft + _shift_fwd(ft)
    bc = (bp * (-dt[..., None])).sum(1)
    return bt, bc, ba, bU1 + bU2, bv, bY


class LoglikFused(torch.autograd.Function):
    """The fused log-likelihood with its hand-derived gradient: the
    backward returns the six cotangents (bt, bc, ba, bU, bV, by)."""

    @staticmethod
    def forward(ctx, t, c, a, U, V, y, block_len):
        ll, saved = _forward(t, c, a, U, V, y, block_len)
        ctx.save_for_backward(c, *saved)
        ctx.block_len = block_len
        ctx.t_batched = t.dim() == 2
        return ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, bll):
        c, *saved = ctx.saved_tensors
        bt, bc, ba, bU, bV, by = _backward(c, saved, bll, ctx.block_len)
        if not ctx.t_batched:
            bt = bt.sum(0)
        return bt, bc, ba, bU, bV, by, None


def pass_inputs(t, c, a, U, V, y, *, block_len=None, structured=None):
    """The inputs each kernel receives when ``loglik_fused`` evaluates
    its value and gradient on this system (with a unit cotangent), keyed
    by kernel name; for holding a kernel against its plain version at
    the main path's shapes.  ``structured`` picks the factor adjoint's
    route (:func:`factor_adjoint`)."""
    L = default_block_len(U.shape[1]) if block_len is None else int(block_len)
    record = {}
    with torch.no_grad():
        ll, saved = _forward(t, c, a, U, V, y, L, record)
        _backward(c, saved, torch.ones_like(ll), L, record, structured)
    return record


def loglik_fused(t, c, a, U, V, y, *, block_len=None):
    """Gaussian-process log-likelihood of C chains, with its gradient.

    ``-0.5 (sum log d + z^T d^{-1} z + N log 2pi)`` per chain, where
    ``d`` and ``z`` come from the Cholesky factor and lower solve of the
    celerite system ``(t, c, a, U, V)`` applied to ``y``.  A chain whose
    system is not positive definite gives ``-inf`` and zero gradients.

    Shapes: ``t (N,)`` or ``(C, N)``, ``c (C, J)``, ``a, y (C, N)``,
    ``U, V (C, N, J)``; J is 1 to 4.  Returns ``(C,)``.  ``block_len``
    is the rows per scan block (default :func:`default_block_len`).
    """
    if U.dim() != 3:
        raise ValueError(f"U must be (C, N, J), got {tuple(U.shape)}")
    C, N, J = U.shape
    if not 1 <= J <= 4:
        raise NotImplementedError(
            f"the fused log-likelihood supports J = 1..4, got J={J} "
            "(wider kernels: ROADMAP.md items A3/A8)"
        )
    for name, x, shape in (
        ("c", c, (C, J)), ("a", a, (C, N)), ("V", V, (C, N, J)), ("y", y, (C, N))
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if t.shape[-1] != N or t.dim() > 2 or (t.dim() == 2 and t.shape[0] != C):
        raise ValueError(f"t must be ({N},) or ({C}, {N}), got {tuple(t.shape)}")
    tensors = (t, c, a, U, V, y)
    if len({x.dtype for x in tensors}) != 1 or len({x.device for x in tensors}) != 1:
        raise ValueError("t, c, a, U, V, y must share dtype and device")
    L = default_block_len(N) if block_len is None else int(block_len)
    return LoglikFused.apply(t, c, a, U, V, y, L)
