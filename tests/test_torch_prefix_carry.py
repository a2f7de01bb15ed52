"""The prefix kernels' modes of the sharded paths, held against the JAX
package: the Riccati and matrix-affine prefixes from an incoming state
(``prev`` and ``S0``, ``x0``) and each chain's total map
(``prefix_engine.riccati_total``, ``mat_affine_total``), through their plain
versions on the CPU, against the full prefix of the JAX package's engine
(``assoc._engine_scan`` with ``riccati_spec(..., full=True)`` and
``mat_affine_spec(..., full=True)``, every leaf valid), which its sharded
functions read; and the paired reverse flow's helpers (``assoc.pair_*``)
against the JAX package's ``_pair_*``.  The CUDA kernels against the plain
versions need the card (marked ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch  # noqa: F401  (the port's CPU default, via torch_parity)
from celerite2_torch.ops import assoc
from celerite2_torch.ops import prefix_engine as pe
from celerite2_tpu.ops import assoc as jassoc
from celerite2_tpu.ops.planes import mat_affine_spec, riccati_spec
from torch_parity import assert_rel_close, t64, wide_system

RTOL = 1e-10


def _shard(J, N, C, k, seed=0):
    """Rows [k, N) of C systems of width J as one shard: ``(p, a, U, V)``
    with row 0's transport against row k - 1, that row ``(a, U, V)``, and
    the state after rows [0, k) (the S0 entering the shard), as numpy."""
    rows = []
    for ci in range(C):
        t, c, a, U, V, _ = wide_system(N, J, 1, seed=seed + ci, sigma=1.0 + 0.2 * ci)
        S = np.zeros((N, J, J))
        s = np.zeros((J, J))
        for n in range(N):  # the factor's carry after each row
            if n:
                pn = np.exp(-c * (t[n] - t[n - 1]))
                u, v = U[n - 1], V[n - 1]
                x = s @ u
                d = a[n - 1] - u @ x
                w = (v - x) / d
                s = pn[:, None] * (s + d * np.outer(w, w)) * pn[None, :]
            S[n] = s
        p = np.exp(-c[None] * (t[k:] - t[k - 1:-1])[:, None])
        rows.append((p, a[k:], U[k:], V[k:], (a[k - 1], U[k - 1], V[k - 1]), S[k - 1]))
    return rows


def _jax_riccati(p, a, U, V, prev):
    """The JAX package's full Riccati prefix of one shard (its sharded
    factor's elements, ``parallel/sharded.py`` :470)."""
    J = U.shape[-1]
    a_prev = jnp.concatenate([jnp.asarray(prev[0])[None], a[:-1]])
    U_prev = jnp.concatenate([jnp.asarray(prev[1])[None], U[:-1]])
    V_prev = jnp.concatenate([jnp.asarray(prev[2])[None], V[:-1]])
    eye = jnp.eye(J)
    al = a_prev[:, None, None]
    A = p[:, :, None] * (eye[None] - V_prev[:, :, None] * U_prev[:, None, :] / al)
    Q = p[:, :, None] * (V_prev[:, :, None] * V_prev[:, None, :] / al) * p[:, None, :]
    R = -U_prev[:, :, None] * U_prev[:, None, :] / al
    return jassoc._engine_scan(jassoc._riccati_combine, (A, Q, R), jassoc._id_riccati,
                               spec=riccati_spec(J, jnp.float64, full=True))


def _jax_state(pref, S0):
    """The state after every row from ``S0`` (the JAX sharded factor's
    phase 3a)."""
    Ap, Qp, Rp = pref
    J = S0.shape[-1]
    S_in = jnp.broadcast_to(S0, Rp.shape)
    G = jassoc._small_inv(jnp.eye(J)[None] + jassoc._bmm(Rp, S_in))
    return Qp + jassoc._bmm(jassoc._bmm(Ap, jassoc._bmm(S_in, G)), jnp.swapaxes(Ap, -1, -2))


@pytest.mark.parametrize("J, N", [(2, 150), (4, 150), (8, 90)])
def test_riccati_carry_and_total_match_jax_full_prefix(J, N):
    C, k = 3, N // 3
    shards = _shard(J, N, C, k, seed=J)
    p, a, U, V = (t64(np.stack([s[i] for s in shards])) for i in range(4))
    prev = tuple(t64(np.stack([s[4][i] for s in shards])) for i in range(3))
    S0 = t64(np.stack([s[5] for s in shards]))
    total = pe.riccati_total_plain(p, a, U, V, prev=prev)
    S = pe.riccati_prefix_plain(p, a, U, V, prev=prev, S0=S0)
    run = jax.jit(lambda *x: _jax_riccati(*x[:4], x[4:7]))
    for ci, s in enumerate(shards):
        pref = run(*(jnp.asarray(x) for x in s[:4]), *map(jnp.asarray, s[4]))
        for leaf, got in zip(pref, total):
            assert_rel_close(got[ci].numpy(), np.asarray(leaf[-1]), RTOL)
        assert_rel_close(S[ci].numpy(), np.asarray(_jax_state(pref, jnp.asarray(s[5]))),
                         RTOL)


def test_riccati_carry_continues_the_whole_sequence():
    """Two shards, the second starting from the first's total: the states of
    the whole sequence from zero (the zero-start call unchanged)."""
    J, N, k = 4, 120, 47
    t, c, a, U, V, _ = wide_system(N, J, 1, seed=5)
    p = t64(np.exp(-c[None] * np.diff(t, prepend=t[0])[:, None]))[None]
    a, U, V = (t64(x)[None] for x in (a, U, V))
    whole = pe.riccati_prefix_plain(p, a, U, V)
    head = pe.riccati_total_plain(p[:, :k], a[:, :k], U[:, :k], V[:, :k])
    prev = (a[:, k - 1], U[:, k - 1], V[:, k - 1])
    tail = pe.riccati_prefix_plain(p[:, k:], a[:, k:], U[:, k:], V[:, k:], prev=prev,
                                   S0=head[1])
    assert_rel_close(head[1].numpy(), whole[:, k - 1].numpy(), RTOL)
    assert_rel_close(tail.numpy(), whole[:, k:].numpy(), RTOL)


def _maps(C, M, D, K, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(C, M, D, D)) * 0.9 / np.sqrt(D)
    return A, rng.normal(size=(C, M, D, K)), rng.normal(size=(C, D, K))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D, K, M", [(2, 1, 200), (4, 3, 200), (9, 1, 150), (25, 1, 100),
                                     (81, 2, 40)])
def test_mat_affine_carry_and_total_match_jax_full_prefix(D, K, M, reverse):
    C = 2
    A, b, x0 = _maps(C, M, D, K, seed=D + M)
    F = pe.mat_affine_prefix_plain(t64(A), t64(b), reverse=reverse, x0=t64(x0))
    P, q = pe.mat_affine_total_plain(t64(A), t64(b), reverse=reverse)
    run = jax.jit(lambda A, b: jassoc._engine_scan(
        jassoc._mat_affine_combine, (A, b), jassoc._id_affine, reverse=reverse,
        spec=mat_affine_spec(D, K, jnp.float64, full=True)))
    for ci in range(C):
        Ap, bp = (np.asarray(x) for x in run(jnp.asarray(A[ci]), jnp.asarray(b[ci])))
        last = 0 if reverse else -1
        assert_rel_close(P[ci].numpy(), Ap[last], RTOL)
        assert_rel_close(q[ci].numpy(), bp[last], RTOL)
        assert_rel_close(F[ci].numpy(), Ap @ x0[ci] + bp, RTOL)


def test_mat_affine_zero_start_unchanged():
    A, b, _ = _maps(2, 64, 4, 2, seed=1)
    A, b = t64(A), t64(b)
    for reverse in (False, True):
        torch.testing.assert_close(
            pe.mat_affine_prefix_plain(A, b, reverse=reverse, x0=torch.zeros_like(b[:, 0])),
            pe.mat_affine_prefix_plain(A, b, reverse=reverse), rtol=0, atol=1e-15)


# ------------------------------------------------ the paired reverse flow


def _pair_par(J, M, seed):
    rng = np.random.default_rng(seed)
    vec = lambda: rng.normal(size=(M, J))  # noqa: E731
    sca = lambda: rng.normal(size=(M,))  # noqa: E731
    p = rng.uniform(0.2, 0.9, size=(M, J))
    return (p, vec(), vec(), vec(), sca(), sca(), vec(), sca(), rng.uniform(0.5, 2, M))


@pytest.mark.parametrize("J", [1, 2, 4, 8])
def test_pair_helpers_match_jax(J):
    M = 17
    par = _pair_par(J, M, seed=J)
    dim = assoc.pair_dim(J)
    assert dim == jassoc._pair_dim(J)
    L, c = assoc.pair_dense_elements(tuple(t64(x)[None] for x in par), dim)
    L_ref, c_ref = jassoc._pair_dense_elements(tuple(jnp.asarray(x) for x in par), dim)
    assert_rel_close(L[0].numpy(), np.asarray(L_ref), 1e-13)
    assert_rel_close(c[0].numpy(), np.asarray(c_ref), 1e-13)
    rng = np.random.default_rng(J + 1)
    x_in = rng.normal(size=(M, dim))
    F_rows, S_half = rng.normal(size=(M, J)), rng.normal(size=(M, J, J))
    p, u, w = par[:3]
    extra = (F_rows, S_half, par[5], par[6], par[7], par[8])
    got = assoc.pair_row_outputs(t64(x_in)[None], *(t64(x)[None] for x in (p, u, w)),
                                 *(t64(x)[None] for x in extra))
    want = jassoc._pair_row_outputs(jnp.asarray(x_in), *map(jnp.asarray, (p, u, w)),
                                    *map(jnp.asarray, extra))
    for g, r in zip(got, want):
        assert_rel_close(g[0].numpy(), np.asarray(r), 1e-13)


# ------------------------------------------- the kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("J", [2, 4, 8])
@pytest.mark.parametrize("block_len", [None, 8])
def test_riccati_modes_on_the_card(cuda, J, block_len):
    from celerite2_torch.ops import _build

    N, C, k = 1040, 3, 300
    shards = _shard(J, N, C, k, seed=J)
    p, a, U, V = (t64(np.stack([s[i] for s in shards])).to(cuda) for i in range(4))
    prev = tuple(t64(np.stack([s[4][i] for s in shards])).to(cuda) for i in range(3))
    S0 = t64(np.stack([s[5] for s in shards])).to(cuda)
    got = _build.riccati_total_cuda(p, a, U, V, block_len, prev=prev)
    for g, w in zip(got, pe.riccati_total_plain(p, a, U, V, prev=prev)):
        assert_rel_close(g.cpu().numpy(), w.cpu().numpy(), 1e-9)
    S = _build.riccati_prefix_cuda(p, a, U, V, block_len, prev=prev, S0=S0)
    assert_rel_close(S.cpu().numpy(),
                     pe.riccati_prefix_plain(p, a, U, V, prev=prev, S0=S0).cpu().numpy(),
                     1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D, K", [(4, 1), (8, 3), (25, 1), (81, 1)])
def test_mat_affine_modes_on_the_card(cuda, D, K, reverse):
    from celerite2_torch.ops import _build

    A, b, x0 = (t64(x).to(cuda) for x in _maps(2, 1040, D, K, seed=D))
    P, q = _build.mat_affine_total_cuda(A, b, reverse)
    Pw, qw = pe.mat_affine_total_plain(A, b, reverse=reverse)
    assert_rel_close(P.cpu().numpy(), Pw.cpu().numpy(), 1e-10)
    assert_rel_close(q.cpu().numpy(), qw.cpu().numpy(), 1e-10)
    F = _build.mat_affine_prefix_cuda(A, b, reverse, x0=x0)
    assert_rel_close(F.cpu().numpy(),
                     pe.mat_affine_prefix_plain(A, b, reverse=reverse, x0=x0).cpu().numpy(),
                     1e-10)
