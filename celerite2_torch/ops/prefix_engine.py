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

(The diagonal-affine family is ``scan.affine_prefix``.)

Each exists twice.  ``*_plain`` is a Hillis-Steele doubling of the family's
combine along the rows (``elements.riccati_combine``, ``kalman_combine``,
``affine_combine``, with their clamped inverse and symmetrisation), as
``scan.affine_prefix_plain`` does for the diagonal family: the CPU route,
and what the kernels are held against.  Without a suffix, the CUDA kernels
of ``csrc/assoc_prefix.cu`` for CUDA tensors (blocks of rows composed side
by side, a walk over the block maps, then every block's rows from the state
entering it) and the plain doubling for CPU tensors.

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
    "kalman_prefix",
    "kalman_prefix_plain",
    "mat_affine_prefix",
    "mat_affine_prefix_plain",
]


def shift_rows(x, upper=False):
    """Row n - 1 (``upper``: n + 1) of ``x (C, N, ...)`` at row n, zero at
    the row where nothing enters."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([x[:, 1:], zero], 1) if upper else torch.cat([zero, x[:, :-1]], 1)


def riccati_elements(p, a, U, V):
    """``(A, Q, R)`` of every row, ``(C, N, J, J)`` each
    (``assoc.factor_assoc``): for n >= 1, from row n - 1 and ``p_n``,

        A = diag(p)(I - v u^T / a),  Q = diag(p) v v^T diag(p) / a,
        R = -u u^T / a,

    with ``a`` guarded (a non-positive diagonal divides by 1); row 0 is the
    identity."""
    J = U.shape[-1]
    u, v = shift_rows(U), shift_rows(V)
    ar = _safe(shift_rows(a))[..., None, None]
    eye = torch.eye(J, dtype=U.dtype, device=U.device)
    A = p[..., :, None] * (eye - v[..., :, None] * u[..., None, :] / ar)
    Q = p[..., :, None] * (v[..., :, None] * v[..., None, :] / ar) * p[..., None, :]
    R = -(u[..., :, None] * u[..., None, :]) / ar
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


def riccati_prefix_plain(p, a, U, V):
    """Plain version of the Riccati prefix kernel: ``S (C, N, J, J)``, the
    Q leaf of the inclusive prefix of :func:`riccati_elements`."""
    return _doubling(el.riccati_combine, riccati_elements(p, a, U, V))[1]


def kalman_prefix_plain(p, a, U, V, Y):
    """Plain version of the Kalman prefix kernel: ``(S, F)``, the Q and b
    leaves of the inclusive prefix of :func:`kalman_elements`."""
    out = _doubling(el.kalman_combine, kalman_elements(p, a, U, V, Y))
    return out[1], out[3]


def mat_affine_prefix_plain(A, b, *, reverse=False):
    """Plain version of the matrix-affine prefix kernel: the b leaf of the
    inclusive prefix of ``(A (C, M, D, D), b (C, M, D, K))`` under
    ``affine_combine``, over the rows descending with ``reverse``."""
    if reverse:
        A, b = A.flip(1), b.flip(1)
    out = _doubling(el.affine_combine, (A, b))[1]
    return out.flip(1) if reverse else out


def riccati_prefix(p, a, U, V):
    """The Riccati prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU."""
    if p.device.type == "cpu":
        return riccati_prefix_plain(p, a, U, V)
    return _build.riccati_prefix_cuda(p, a, U, V)


def kalman_prefix(p, a, U, V, Y):
    """The Kalman prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU.  Returns ``(S, F)``."""
    if p.device.type == "cpu":
        return kalman_prefix_plain(p, a, U, V, Y)
    return _build.kalman_prefix_cuda(p, a, U, V, Y)


def mat_affine_prefix(A, b, *, reverse=False):
    """The matrix-affine prefix: the CUDA kernel for CUDA tensors, the plain
    doubling on the CPU."""
    if b.device.type == "cpu":
        return mat_affine_prefix_plain(A, b, reverse=reverse)
    return _build.mat_affine_prefix_cuda(A.contiguous(), b.contiguous(), reverse)
