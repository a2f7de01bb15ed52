"""The inclusive prefix of the assoc tier's element families over the rows.

Counterpart of ``celerite2_tpu/ops/planes_engine.py`` (``prefix_planes``,
``_two_level``, ``_leaf_scan`` and the Pallas kernel
``_block_prefix_kernel``) and of the generic engines of
``celerite2_tpu/ops/assoc.py`` (``two_level_prefix``, ``_engine_scan``).
One entry point per family; each takes a leading chain axis and returns
the state leaves the assoc functions use (the prefix applied to the zero
state):

* :func:`riccati_prefix`: the factor's Riccati elements, built from the row
  data ``(p, a, U, V)`` as ``assoc.factor_assoc`` builds them; returns the
  carry ``S (C, N, J, J)`` (the Q leaf) after every row;
* :func:`kalman_prefix`: the same with the lower solve's two leaves (``b``,
  ``eta``) for right-hand sides ``Y (C, N, K)``, as
  ``assoc.factor_solve_assoc``; returns ``S`` and ``F (C, N, J, K)`` (the b
  leaf);
* :func:`mat_affine_prefix`: ``x -> A x + b`` over given ``A (C, M, D, D)``
  and ``b (C, M, D, K)``, forward or reverse; returns the b leaf.

(The diagonal-affine family is ``scan.affine_prefix``, with its kernel's
order in ``scan.affine_prefix_tiled``.)

A sequence split over ranks (``celerite2_torch.parallel``) needs two more
things of the Riccati and matrix-affine families, which the kernels give
too: the prefix from an **incoming state** (``prev`` and ``S0`` of
:func:`riccati_prefix`, ``x0`` of :func:`mat_affine_prefix`), and each
chain's **total map** without the rows' states (:func:`riccati_total`,
:func:`mat_affine_total`), which the ranks exchange.

Each exists twice.  ``*_plain`` is a Hillis-Steele doubling of the family's
combine along the rows (``elements.riccati_combine``, ``kalman_combine``,
``affine_combine``, with their clamped inverse and symmetrisation), as
``scan.affine_prefix_plain`` does for the diagonal family: the CPU route,
and what the kernels are held against.  Without a suffix, the CUDA kernels
of ``csrc/assoc_prefix.cu`` for CUDA tensors (blocks of rows composed side
by side, a scan over the block maps, then every block's rows from the state
entering it) and the plain doubling for CPU tensors; above D = 32, where
the matrix-affine kernel walks the rows, the CPU route walks them too
(:func:`mat_affine_walk`): the doubling's products of stiff maps lose the
digits a walk keeps (ROADMAP C9).
:func:`kalman_prefix_blocked` and :func:`mat_affine_prefix_blocked`
compose the elements in the order of their kernels, for the tests on the
CPU.

The doubling composes full (C, N, J, J) elements with ``torch.matmul``; on
the card keep TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default) when running it in float32.
"""

from __future__ import annotations

import torch

from celerite2_torch.ops import _build
from celerite2_torch.ops import elements as el
from celerite2_torch.ops.scan import _safe

__all__ = [
    "shift_rows",
    "riccati_elements",
    "kalman_elements",
    "riccati_prefix",
    "riccati_prefix_plain",
    "riccati_total",
    "riccati_total_plain",
    "kalman_prefix",
    "kalman_prefix_plain",
    "kalman_prefix_blocked",
    "mat_affine_group",
    "mat_affine_prefix",
    "mat_affine_prefix_plain",
    "mat_affine_prefix_blocked",
    "mat_affine_total",
    "mat_affine_total_plain",
    "mat_affine_walk",
]


def shift_rows(x, upper=False):
    """Row n - 1 (``upper``: n + 1) of ``x (C, N, ...)`` at row n, zero at
    the row where nothing enters."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([x[:, 1:], zero], 1) if upper else torch.cat([zero, x[:, :-1]], 1)


def riccati_elements(p, a, U, V, prev=None):
    """``(A, Q, R)`` of every row, ``(C, N, J, J)`` each
    (``assoc.factor_assoc``): for n >= 1, from row n - 1 and ``p_n``,

        A = diag(p)(I - v u^T / a),  Q = diag(p) v v^T diag(p) / a,
        R = -u u^T / a,

    with ``a`` guarded (a non-positive diagonal divides by 1); row 0 is the
    identity, or with ``prev = (a (C,), U (C, J), V (C, J))`` built the same
    way from that row and ``p_0``."""
    J = U.shape[-1]
    u, v, ar = shift_rows(U), shift_rows(V), shift_rows(a)
    if prev is not None:
        a0, u0, v0 = prev
        u, v = torch.cat([u0[:, None], u[:, 1:]], 1), torch.cat([v0[:, None], v[:, 1:]], 1)
        ar = torch.cat([a0[:, None], ar[:, 1:]], 1)
    ar = _safe(ar)[..., None, None]
    eye = torch.eye(J, dtype=U.dtype, device=U.device)
    A = p[..., :, None] * (eye - v[..., :, None] * u[..., None, :] / ar)
    Q = p[..., :, None] * (v[..., :, None] * v[..., None, :] / ar) * p[..., None, :]
    R = -(u[..., :, None] * u[..., None, :]) / ar
    if prev is not None:
        return A, Q, R
    first = torch.zeros_like(p[:, :, :1, None], dtype=torch.bool)
    first[:, 0] = True
    return (torch.where(first, eye, A), torch.where(first, 0.0, Q),
            torch.where(first, 0.0, R))


def kalman_elements(p, a, U, V, Y):
    """``(A, Q, R, b, eta)`` of every row (``assoc.factor_solve_assoc``):
    the Riccati elements and, for n >= 1, ``b = diag(p) v y^T / a``, ``eta
    = -u y^T / a`` from row n - 1; row 0 is the identity."""
    A, Q, R = riccati_elements(p, a, U, V)
    yo = shift_rows(Y / _safe(a)[..., None])[..., None, :]
    b = p[..., :, None] * shift_rows(V)[..., :, None] * yo
    eta = -shift_rows(U)[..., :, None] * yo
    return A, Q, R, b, eta


def _doubling(combine, elems):
    """Inclusive prefix along dim 1 of the ``(C, M, ...)`` leaves of
    ``elems``: ceil(log2 M) levels of ``x_m <- combine(x_{m-k}, x_m)`` for
    m >= k."""
    M = elems[0].shape[1]
    k = 1
    while k < M:
        new = combine(tuple(x[:, :-k] for x in elems),
                      tuple(x[:, k:] for x in elems))
        elems = tuple(torch.cat([x[:, :k], y], 1) for x, y in zip(elems, new))
        k *= 2
    return elems


def riccati_prefix_plain(p, a, U, V, *, prev=None, S0=None):
    """Plain version of the Riccati prefix kernel: ``S (C, N, J, J)``, the
    Q leaf of the inclusive prefix of :func:`riccati_elements` (row 0's
    element from ``prev`` when given), applied to ``S0 (C, J, J)`` (None:
    zero)."""
    pref = _doubling(el.riccati_combine, riccati_elements(p, a, U, V, prev))
    if S0 is None:
        return pref[1]
    state = (None, S0[:, None].expand_as(pref[1]), None)
    return el.riccati_distribute(state, pref)[1]


def riccati_total_plain(p, a, U, V, *, prev=None):
    """Plain version of the Riccati total kernels: ``(A, Q, R)``, each ``(C,
    J, J)``, the last row of the inclusive prefix of
    :func:`riccati_elements`."""
    pref = _doubling(el.riccati_combine, riccati_elements(p, a, U, V, prev))
    return tuple(x[:, -1] for x in pref)


def kalman_prefix_plain(p, a, U, V, Y):
    """Plain version of the Kalman prefix kernel: ``(S, F)``, the Q and b
    leaves of the inclusive prefix of :func:`kalman_elements`."""
    out = _doubling(el.kalman_combine, kalman_elements(p, a, U, V, Y))
    return out[1], out[3]


def _identity(elems, C, M):
    """The identity element, ``(C, M, ...)`` leaves shaped as ``elems``'."""
    A = elems[0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return (eye.expand(C, M, *A.shape[2:]),) + tuple(
        x.new_zeros(C, M, *x.shape[2:]) for x in elems[1:])


def _grouped(elems, size):
    """``(C, M, ...)`` leaves padded with the identity to a multiple of
    ``size`` rows and viewed as ``(C, ceil(M / size), size, ...)``."""
    C, M = elems[0].shape[:2]
    pad = -M % size
    elems = tuple(torch.cat([x, i], 1)
                  for x, i in zip(elems, _identity(elems, C, pad)))
    return tuple(x.reshape(C, -1, size, *x.shape[2:]) for x in elems)


# The Riccati and Kalman kernels' blocks a group and, at J <= 4, the threads
# of their scan over the groups (csrc/assoc_prefix.cu kGroup, which the C
# interface reports as c2t_riccati_group, and kScanThreads).
KERNEL_GROUP = 32
KERNEL_SCAN_THREADS = 128


def kalman_prefix_blocked(p, a, U, V, Y=None, *, block_len,
                          scan_threads=KERNEL_SCAN_THREADS):
    """The Riccati (``Y`` None) or Kalman prefix composed in the order of
    the CUDA kernels (``_build.kalman_prefix_cuda``), with the plain
    combines of ``ops/elements.py``.  The elements of every block of
    ``block_len`` rows are composed in order into the block's map; the
    blocks go in groups of :data:`KERNEL_GROUP`.  Then, at J <= 4:

    * each block's prefix within its group, by doubling over the group;
    * the groups' maps in runs of ceil(groups / ``scan_threads``): each run
      composed in order, the runs' maps scanned by doubling, and each
      run's groups walked from the state entering the run;
    * the state entering each block: that entering its group carried over
      its prefix of the blocks before it.

    From J = 8 the maps of every group are composed in order, the state is
    carried over the groups' maps from zero, then over each group's block
    maps from the state entering the group.  Last, every block's rows again
    from the state entering it.  Returns what :func:`riccati_prefix_plain`
    or :func:`kalman_prefix_plain` returns.  A plain version of the kernels'
    order, for the tests on the CPU; nothing on the card's path calls it."""
    kalman = Y is not None
    if kalman:
        elems = kalman_elements(p, a, U, V, Y)
        combine, apply = el.kalman_combine, el.kalman_distribute
    else:
        elems = riccati_elements(p, a, U, V)
        combine, apply = el.riccati_combine, el.riccati_distribute
    C, N, J = U.shape

    def compose(seq):  # the in-order composition along dim 2
        out = tuple(x[:, :, 0] for x in seq)
        for k in range(1, seq[0].shape[2]):
            out = combine(out, tuple(x[:, :, k] for x in seq))
        return out

    def walk(state, seq):  # the state entering every step along dim 2
        states = []
        for k in range(seq[0].shape[2]):
            states.append(state)
            state = apply(state, tuple(x[:, :, k] for x in seq))
        return tuple(torch.stack(x, 2) for x in zip(*states))

    def scan(seq):  # inclusive doubling along dim 2
        B, M = seq[0].shape[:2]
        out = _doubling(combine, tuple(x.flatten(0, 1) for x in seq))
        return tuple(x.reshape(B, M, *x.shape[1:]) for x in out)

    def shifted(seq):  # the identity, then all but the last along dim 1
        return tuple(torch.cat([i, x[:, :-1]], 1)
                     for i, x in zip(_identity(elems, C, 1), seq))

    rows = _grouped(elems, block_len)
    NB = rows[0].shape[1]
    groups = _grouped(compose(rows), KERNEL_GROUP)
    GB = groups[0].shape[1]
    # a map serves as a state: apply reads its Q and b leaves only
    if J <= 4:
        within = scan(groups)
        runs = _grouped(tuple(x[:, :, -1] for x in within),
                        -(-GB // scan_threads))
        at_runs = shifted(_doubling(combine, compose(runs)))
        at_groups = walk(at_runs, runs)
        at_groups = tuple(x.flatten(1, 2)[:, :GB] for x in at_groups)
        before = tuple(
            torch.cat([i[:, :, None].expand_as(x[:, :, :1]), x[:, :, :-1]], 2)
            for i, x in zip(_identity(elems, C, GB), within))
        entering = apply(tuple(x[:, :, None].expand_as(y)
                               for x, y in zip(at_groups, before)), before)
    else:
        totals = tuple(x[:, None] for x in compose(groups))
        at_groups = walk(_identity(elems, C, 1), totals)
        entering = walk(tuple(x[:, 0] for x in at_groups), groups)
    entering = tuple(x.flatten(1, 2)[:, :NB] for x in entering)
    after = []
    state = entering
    for k in range(block_len):
        state = apply(state, tuple(x[:, :, k] for x in rows))
        after.append(state)
    out = tuple(torch.stack(x, 2).flatten(1, 2)[:, :N] for x in zip(*after))
    return (out[1], out[3]) if kalman else out[1]


def mat_affine_group(D):
    """The blocks of a group of the matrix-affine kernels at width D
    (csrc/assoc_prefix.cu ``Ma<DP>::GS``, which the C interface reports as
    c2t_mat_affine_group): 64 up to D = 4, 32 at D <= 8, 16 at D <= 16, 8
    at D <= 32, 0 above, where one walk takes every row."""
    DP = 1
    while DP < D:
        DP *= 2
    return {8: 32, 16: 16, 32: 8}.get(DP, 64 if DP <= 4 else 0)


def mat_affine_prefix_blocked(A, b, *, reverse=False, block_len):
    """The matrix-affine prefix composed in the order of the CUDA kernels
    (``_build.mat_affine_prefix_cuda``), with the plain combines of
    ``ops/elements.py``.  Up to D = 32: the rows of every block of
    ``block_len`` composed in order into the block's map; each group of
    :func:`mat_affine_group` blocks scanned by doubling (each block's prefix
    within its group, the group's map last); the value carried over the
    groups' maps from zero, in order; the value entering each block, that
    entering its group carried over the prefix of the blocks before it;
    then every block's rows again from it.  Above D = 32, one walk over the
    rows.  Returns what :func:`mat_affine_prefix_plain` returns.  A plain
    version of the kernels' order, for the tests on the CPU; nothing on the
    card's path calls it."""
    C, M, D, K = b.shape
    GS = mat_affine_group(D)
    if GS == 0:
        return mat_affine_walk(A, b, reverse=reverse)
    if reverse:
        A, b = A.flip(1), b.flip(1)

    def compose(seq):  # the in-order composition along dim 2
        out = tuple(x[:, :, 0] for x in seq)
        for k in range(1, seq[0].shape[2]):
            out = el.affine_combine(out, tuple(x[:, :, k] for x in seq))
        return out

    rows = _grouped((A, b), block_len)
    NB = rows[0].shape[1]
    groups = _grouped(compose(rows), GS)
    GB = groups[0].shape[1]
    within = tuple(x.reshape(C, GB, GS, *x.shape[2:]) for x in _doubling(
        el.affine_combine, tuple(x.flatten(0, 1) for x in groups)))
    x, at_groups = b.new_zeros(C, D, K), []
    for g in range(GB):
        at_groups.append(x)
        x = within[0][:, g, -1] @ x + within[1][:, g, -1]
    xg = torch.stack(at_groups, 1)[:, :, None]  # (C, GB, 1, D, K)
    before = tuple(torch.cat([i[:, :, None].expand_as(y[:, :, :1]), y[:, :, :-1]], 2)
                   for i, y in zip(_identity((A, b), C, GB), within))
    entering = (before[0] @ xg + before[1]).flatten(1, 2)[:, :NB]
    out, x = [], entering
    for k in range(block_len):
        x = rows[0][:, :, k] @ x + rows[1][:, :, k]
        out.append(x)
    F = torch.stack(out, 2).flatten(1, 2)[:, :M]
    return F.flip(1) if reverse else F


def mat_affine_prefix_plain(A, b, *, reverse=False, x0=None):
    """Plain version of the matrix-affine prefix kernel: the b leaf of the
    inclusive prefix of ``(A (C, M, D, D), b (C, M, D, K))`` under
    ``affine_combine``, over the rows descending with ``reverse``, applied
    to ``x0 (C, D, K)`` (None: zero)."""
    if reverse:
        A, b = A.flip(1), b.flip(1)
    if x0 is None:
        out = _doubling(el.affine_combine, (A, b))[1]
    else:
        PA, out = _doubling(el.affine_combine, (A, b))
        out = out + PA @ x0[:, None]
    return out.flip(1) if reverse else out


def mat_affine_walk(A, b, *, reverse=False, x0=None, total=False):
    """The matrix-affine prefix by one walk over the rows, as the kernel
    walks them above D = 32: ``x <- A_m x + b_m`` from ``x0`` (None: zero),
    rows descending with ``reverse``; returns the value after every row,
    or with ``total`` each chain's total map ``(P, q)`` (P walked from the
    identity alongside)."""
    C, M, D, K = b.shape
    x = b.new_zeros(C, D, K) if x0 is None else x0
    P = torch.eye(D, dtype=b.dtype, device=b.device).expand(C, D, D) if total else None
    out = None if total else b.new_empty(b.shape)
    for m in (range(M - 1, -1, -1) if reverse else range(M)):
        x = A[:, m] @ x + b[:, m]
        if total:
            P = A[:, m] @ P
        else:
            out[:, m] = x
    return (P, x) if total else out


def mat_affine_total_plain(A, b, *, reverse=False):
    """Plain version of the matrix-affine total kernels: ``(P (C, D, D), q
    (C, D, K))``, the last row in walk order of the inclusive prefix."""
    if reverse:
        A, b = A.flip(1), b.flip(1)
    return tuple(x[:, -1] for x in _doubling(el.affine_combine, (A, b)))


def _contiguous(xs):
    return None if xs is None else tuple(x.contiguous() for x in xs)


def riccati_prefix(p, a, U, V, *, prev=None, S0=None):
    """The Riccati prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU.  ``prev`` and ``S0``: the row before row 0 and the
    state entering the chain (:func:`riccati_prefix_plain`)."""
    if p.device.type == "cpu":
        return riccati_prefix_plain(p, a, U, V, prev=prev, S0=S0)
    return _build.riccati_prefix_cuda(
        p, a, U, V, prev=_contiguous(prev),
        S0=None if S0 is None else S0.contiguous())


def riccati_total(p, a, U, V, *, prev=None):
    """Each chain's total Riccati map ``(A, Q, R)``: the CUDA kernels for
    CUDA tensors, the plain doubling on the CPU."""
    if p.device.type == "cpu":
        return riccati_total_plain(p, a, U, V, prev=prev)
    return _build.riccati_total_cuda(p, a, U, V, prev=_contiguous(prev))


def kalman_prefix(p, a, U, V, Y):
    """The Kalman prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU.  Returns ``(S, F)``."""
    if p.device.type == "cpu":
        return kalman_prefix_plain(p, a, U, V, Y)
    return _build.kalman_prefix_cuda(p, a, U, V, Y)


def mat_affine_prefix(A, b, *, reverse=False, x0=None):
    """The matrix-affine prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU (above D = 32 the kernel's walk).  ``x0``: the value
    entering the chain (None: zero)."""
    if b.device.type == "cpu":
        if mat_affine_group(b.shape[-2]) == 0:
            return mat_affine_walk(A, b, reverse=reverse, x0=x0)
        return mat_affine_prefix_plain(A, b, reverse=reverse, x0=x0)
    return _build.mat_affine_prefix_cuda(
        A.contiguous(), b.contiguous(), reverse,
        x0=None if x0 is None else x0.contiguous())


def mat_affine_total(A, b, *, reverse=False):
    """Each chain's total matrix-affine map ``(P, q)``: the CUDA kernels for
    CUDA tensors, the plain doubling on the CPU (above D = 32 the kernel's
    walk)."""
    if b.device.type == "cpu":
        if mat_affine_group(b.shape[-2]) == 0:
            return mat_affine_walk(A, b, reverse=reverse, total=True)
        return mat_affine_total_plain(A, b, reverse=reverse)
    return _build.mat_affine_total_cuda(A.contiguous(), b.contiguous(), reverse)
