"""Monoid element algebra for the fused log-likelihood's scans.

Counterpart of ``celerite2_tpu/ops/planes.py`` (``riccati_spec``,
``kalman_spec``, ``mat_affine_spec``, the clamped small inverse ``p_inv``
and the symmetrisation ``p_sym``; ``ops/assoc.py``'s ``_riccati_combine``,
``_kalman_combine``, ``_mat_affine_combine`` and their distribute
variants) and of the Hillis-Steele prefix ``planes_engine._leaf_scan``.
The JAX package stores each matrix entry
as its own plane so the TPU's vector unit sees full tiles; here an
element is a tuple of ordinary ``(..., J, J)`` / ``(..., J, 1)``
tensors and the algebra is batched ``torch.matmul``.

This is plain tensor code for the cross-block level of K3 (composing
the block maps its kernel emits, and distributing the exclusive block
states over the rows), and for the kernels' plain versions.  The CUDA
kernels in ``csrc/fused_loglik.cu`` carry the same formulas (K1, K2 their
cross-block level too, on the card); those of ``csrc/assoc_prefix.cu``
and K1's row steps their rank-one forms.

Convention, as in the JAX package: ``combine(e1, e2)`` with ``e1``
earlier and ``e2`` later.
"""

from __future__ import annotations

import torch

__all__ = [
    "inv_clamped",
    "sym",
    "riccati_combine",
    "riccati_distribute",
    "kalman_combine",
    "kalman_distribute",
    "kalman_identity",
    "affine_combine",
    "affine_distribute",
    "affine_identity",
    "exclusive_block_states",
]


def sym(X):
    """0.5 (X + X^T): keeps the covariance-like leaves symmetric."""
    return 0.5 * (X + X.mT)


def inv_clamped(M):
    """Closed-form inverse of ``(..., J, J)``, mirroring ``planes.p_inv``:
    1x1; 2x2 with the scale-aware determinant floor
    (``planes._det2_clamped``); even sizes by the 2x2-block Schur
    recursion, the clamped inverse applied to the leading block and to
    the Schur complement; odd sizes bordered with an identity row and
    column.  No pivoting: the clamp decides what a near-singular combine
    returns, as in the JAX package."""
    J = M.shape[-1]
    if J == 1:
        return 1.0 / M
    if J == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        fin = torch.finfo(M.dtype)
        floor = fin.eps * (torch.abs(a * d) + torch.abs(b * c)) + fin.tiny
        det = torch.where(
            torch.abs(det) >= floor, det, torch.where(det < 0, -floor, floor)
        )
        r = 1.0 / det
        return torch.stack(
            [torch.stack([d * r, -b * r], -1), torch.stack([-c * r, a * r], -1)],
            -2,
        )
    if J % 2:
        Mp = M.new_zeros(*M.shape[:-2], J + 1, J + 1)
        Mp[..., :J, :J] = M
        Mp[..., J, J] = 1.0
        return inv_clamped(Mp)[..., :J, :J]
    h = J // 2
    A, B = M[..., :h, :h], M[..., :h, h:]
    C, D = M[..., h:, :h], M[..., h:, h:]
    Ai = inv_clamped(A)
    AiB = Ai @ B
    Si = inv_clamped(D - C @ AiB)
    CAi = C @ Ai
    AiBSi = AiB @ Si
    top = torch.cat([Ai + AiBSi @ CAi, -AiBSi], -1)
    bot = torch.cat([-(Si @ CAi), Si], -1)
    return torch.cat([top, bot], -2)


def _eye_like(X):
    return torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)


# ----------------------------------------------------- Riccati (factor)
#
# (A, Q, R): S -> Q + A S (I + R S)^{-1} A^T, the factor's carry map
# (planes.riccati_spec / assoc._riccati_combine).  Q carries the state.


def riccati_combine(e1, e2):
    A1, Q1, R1 = e1
    A2, Q2, R2 = e2
    G = inv_clamped(_eye_like(Q1) + Q1 @ R2)
    A12 = A2 @ (G @ A1)
    Q12 = Q2 + (A2 @ (G @ Q1)) @ A2.mT
    R12 = R1 + (A1.mT @ (R2 @ G)) @ A1
    return (A12, sym(Q12), sym(R12))


def riccati_distribute(e1, e2):
    """Reduced combine: only Q (the state applied to zero) is valid."""
    A1, Q1, R1 = e1
    A2, Q2, R2 = e2
    GQ1 = inv_clamped(_eye_like(Q1) + Q1 @ R2) @ Q1
    return (A2, sym(Q2 + (A2 @ GQ1) @ A2.mT), R2)


# ------------------------------------------------ Kalman (factor+solve)
#
# (A, Q, R, b, eta): the fused Cholesky factor + lower solve element
# (planes.kalman_spec / assoc._kalman_combine).  Q carries the
# covariance state, b the solve state.


def kalman_combine(e1, e2):
    A1, Q1, R1, b1, eta1 = e1
    A2, Q2, R2, b2, eta2 = e2
    G = inv_clamped(_eye_like(Q1) + Q1 @ R2)
    GA1 = G @ A1
    GQ1 = G @ Q1
    Gb = G @ (b1 + Q1 @ eta2)
    R2G = R2 @ G
    vE = eta2 - R2 @ b1
    Eeta = vE - R2G @ (Q1 @ vE)
    A12 = A2 @ GA1
    Q12 = Q2 + (A2 @ GQ1) @ A2.mT
    R12 = R1 + (A1.mT @ R2G) @ A1
    b12 = b2 + A2 @ Gb
    eta12 = eta1 + A1.mT @ Eeta
    return (A12, sym(Q12), sym(R12), b12, eta12)


def kalman_distribute(e1, e2):
    """Reduced combine: only Q (covariance) and b (mean) are valid."""
    A1, Q1, R1, b1, eta1 = e1
    A2, Q2, R2, b2, eta2 = e2
    G = inv_clamped(_eye_like(Q1) + Q1 @ R2)
    GQ1 = G @ Q1
    Gb = G @ (b1 + Q1 @ eta2)
    Q12 = Q2 + (A2 @ GQ1) @ A2.mT
    b12 = b2 + A2 @ Gb
    return (A2, sym(Q12), R2, b12, eta2)


def kalman_identity(shape, J, *, dtype, device):
    eye = torch.eye(J, dtype=dtype, device=device).expand(*shape, J, J)
    zJJ = torch.zeros(*shape, J, J, dtype=dtype, device=device)
    zJ1 = torch.zeros(*shape, J, 1, dtype=dtype, device=device)
    return (eye, zJJ, zJJ, zJ1, zJ1)


# -------------------------------------------------------- affine maps
#
# (A, b): x -> A x + b (planes.mat_affine_spec; b is (..., D, K)).


def affine_combine(e1, e2):
    A1, b1 = e1
    A2, b2 = e2
    return (A2 @ A1, A2 @ b1 + b2)


def affine_distribute(e1, e2):
    """Reduced combine: only b (the composed state) is valid."""
    A1, b1 = e1
    A2, b2 = e2
    return (A2, A2 @ b1 + b2)


def affine_identity(shape, D, *, dtype, device):
    eye = torch.eye(D, dtype=dtype, device=device).expand(*shape, D, D)
    return (eye, torch.zeros(*shape, D, 1, dtype=dtype, device=device))


# ---------------------------------------------------- cross-block level


def exclusive_block_states(maps, combine, identity, *, reverse):
    """Exclusive prefix (``reverse``: suffix) composition of block maps.

    ``maps`` is an element whose tensors are ``(C, NB, ...)``; the
    result has the same shapes, and its entry ``b`` composes the maps of
    every block before ``b`` (``reverse``: after ``b``).  Hillis-Steele
    doubling: ceil(log2 NB) full-width combines.
    """
    if reverse:
        maps = tuple(m.flip(1) for m in maps)
    NB = maps[0].shape[1]
    k = 1
    while k < NB:
        shifted = tuple(
            torch.cat([i[:, :k], m[:, :-k]], 1) for m, i in zip(maps, identity)
        )
        maps = combine(shifted, maps)
        k *= 2
    excl = tuple(
        torch.cat([i[:, :1], m[:, :-1]], 1) for m, i in zip(maps, identity)
    )
    if reverse:
        excl = tuple(m.flip(1) for m in excl)
    return excl
