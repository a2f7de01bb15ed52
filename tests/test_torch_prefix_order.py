"""The matrix-affine and diagonal-affine prefixes in the order of their CUDA
kernels (``prefix_engine.mat_affine_prefix_blocked``,
``scan.affine_prefix_tiled``, with the plain combines of ops/elements.py)
under the port's assoc tier, against the JAX package's assoc tier
(celerite2_tpu.ops.assoc, jitted, float64 on the CPU), on the same numpy
inputs: the solves, the solve adjoint, phase B of the factor adjoint, the
matmuls, the matmul adjoint and the diagonal scan itself.  Blocks of 2
rows up to D = 4 and of 4 at D = 8 (a group of the matrix-affine kernels
is 64 blocks up to D = 4 and 32 at D = 8) and tiles of 32 one-row runs, at
N = 127, 128 and 129, so that the rows fill one group or spill into a
second, and several tiles.  Tolerance 1e-9 relative to each array's
largest entry (test_forward_ops_match_jax's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celerite2_torch.ops import assoc as tassoc
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan as tscan
from celerite2_tpu import terms as jt
from celerite2_tpu.ops import assoc as jassoc
from torch_parity import assert_rel_close, t64

ROWS = [127, 128, 129]
RUN = 1  # rows a run of the diagonal-affine kernel: tiles of 32 rows


def _block_len(D):
    """Rows a block at width D: 128 rows fill one group."""
    return 128 // pe.mat_affine_group(D)


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def _stiff(J, N, K):
    """One system of width J with K right-hand sides: a RealTerm at J = 1;
    wide8's stiff term (the SHOTerm at Q = 0.5) alone at J = 2, beside
    wide8's first term at J = 4, wide8 at theta = log[1, 5, 3] at J = 8;
    t ~ U(0, N / 10)."""
    rng = np.random.default_rng(J + N + K)
    t = np.sort(rng.uniform(0, N / 10, N))
    terms = [jt.SHOTerm(sigma=1.0, rho=5.0, tau=3.0)] + [
        jt.SHOTerm(sigma=0.5 + 0.2 * j, rho=5.0 * (1.7 + j), Q=0.3 + 0.1 * j)
        for j in range(3)]
    kernel = {1: jt.RealTerm(a=1.0, c=0.5), 2: terms[3], 4: terms[0] + terms[3],
              8: jt.TermSum(*terms)}[J]
    c, a, U, V = kernel.get_celerite_matrices(t, np.full(N, 0.0625))
    Y = rng.normal(size=(N, K))
    return tuple(np.asarray(x) for x in (t, c, a, U, V, Y)), rng


def _hold(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g[0].numpy(), np.asarray(w), 1e-9, f"{what} output {i}")


@pytest.mark.parametrize("N", ROWS)
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("J", [1, 2, 4, 8])
def test_mat_affine_kernel_order_matches_jax(monkeypatch, J, K, N):
    """The solves (solve_lower forward, solve_upper reverse) and their
    adjoint (sweep_rev_assoc, against each solve's direction) with the
    matrix-affine prefix in its kernels' order, against the JAX package's
    solve_lower_assoc, solve_upper_assoc and sweep_rev_assoc."""
    (t, c, a, U, V, Y), rng = _stiff(J, N, K)
    W = np.asarray(_jit(jassoc.factor_assoc)(*map(jnp.asarray, (t, c, a, U, V)))[1])
    bZ = rng.normal(size=Y.shape)
    monkeypatch.setattr(pe, "mat_affine_prefix", lambda A, b, reverse=False: (
        pe.mat_affine_prefix_blocked(A, b, reverse=reverse,
                                     block_len=_block_len(A.shape[-1]))))
    for op, upper in (("solve_lower", False), ("solve_upper", True)):
        Z, F = _jit(getattr(jassoc, f"{op}_assoc"))(*map(jnp.asarray, (t, c, U, W, Y)))
        got = getattr(tassoc, f"{op}_assoc")(*(t64(x)[None] for x in (t, c, U, W, Y)))
        _hold(got, (Z, F), op)
        A, B = (W, U) if upper else (U, W)
        args = (t, c, A, B, Y, np.asarray(Z), np.asarray(F), bZ)
        want = _jit(jassoc.sweep_rev_assoc, is_solve=True, upper=upper)(
            *map(jnp.asarray, args))
        got = tassoc.sweep_rev_assoc(*(t64(x)[None] for x in args), is_solve=True,
                                     upper=upper)
        _hold(got, want, f"sweep_rev of {op}")


@pytest.mark.parametrize("J, N", [(2, 130), (8, 130)])
def test_mat_affine_kernel_order_in_factor_adjoint_matches_jax(monkeypatch, J, N):
    """The factor adjoint (factor_rev_assoc) with the matrix-affine prefix
    in its kernels' order, against the JAX package's: at J = 2 the
    per-step maps of D = J^2 = 4 over N - 1 = 129 steps in reverse (65
    blocks, two groups); at J = 8 phase B's block maps, D = J^2 = 64 and
    M = 5 <= 128 (one walk over the maps)."""
    (t, c, a, U, V, _), rng = _stiff(J, N, 1)
    d, W, S = map(np.asarray, _jit(jassoc.factor_assoc)(*map(jnp.asarray, (t, c, a, U, V))))
    args = (t, c, a, U, V, d, W, S, rng.normal(size=d.shape), rng.normal(size=W.shape))
    want = _jit(jassoc.factor_rev_assoc)(*map(jnp.asarray, args))
    seen = []

    def blocked(A, b, reverse=False):
        seen.append(A.shape[-1])
        return pe.mat_affine_prefix_blocked(A, b, reverse=reverse, block_len=2)

    monkeypatch.setattr(pe, "mat_affine_prefix", blocked)
    got = tassoc.factor_rev_assoc(*(t64(x)[None] for x in args))
    assert seen == [J * J]
    _hold(got, want, f"factor_rev_assoc, J = {J}")


@pytest.mark.parametrize("N", ROWS)
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("J", [1, 2, 4, 8])
def test_diag_affine_kernel_order_matches_jax(monkeypatch, J, K, N):
    """The matmuls (matmul_lower forward, matmul_upper reverse), their
    adjoint (sweep_rev_assoc) and the diagonal scan itself in both
    directions, with the diagonal-affine prefix in its kernel's order,
    against the JAX package's matmul_lower_assoc, matmul_upper_assoc,
    sweep_rev_assoc and _diag_affine_scan."""
    (t, c, a, U, V, Y), rng = _stiff(J, N, K)
    bZ = rng.normal(size=Y.shape)
    monkeypatch.setattr(tscan, "affine_prefix", lambda phi, G, reverse=False: (
        tscan.affine_prefix_tiled(phi, G, reverse=reverse, run=RUN)))
    for op, upper in (("matmul_lower", False), ("matmul_upper", True)):
        Z, F = _jit(getattr(jassoc, f"{op}_assoc"))(*map(jnp.asarray, (t, c, U, V, Y)))
        got = getattr(tassoc, f"{op}_assoc")(*(t64(x)[None] for x in (t, c, U, V, Y)))
        _hold(got, (Z, F), op)
        A, B = (V, U) if upper else (U, V)
        args = (t, c, A, B, Y, np.asarray(Z), np.asarray(F), bZ)
        want = _jit(jassoc.sweep_rev_assoc, is_solve=False, upper=upper)(
            *map(jnp.asarray, args))
        got = tassoc.sweep_rev_assoc(*(t64(x)[None] for x in args), is_solve=False,
                                     upper=upper)
        _hold(got, want, f"sweep_rev of {op}")
    phi = np.asarray(tscan.transport(t64(t)[None], t64(c)[None])[0])
    beta = rng.normal(size=(N, U.shape[1], K))
    for reverse in (False, True):
        want = _jit(jassoc._diag_affine_scan, reverse=reverse)(
            jnp.broadcast_to(jnp.asarray(phi)[:, :, None], beta.shape), jnp.asarray(beta))
        got = tscan.affine_prefix_tiled(t64(phi)[None], t64(beta)[None],
                                        reverse=reverse, run=RUN)
        _hold((got,), (want,), f"_diag_affine_scan, reverse={reverse}")
