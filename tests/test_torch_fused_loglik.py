"""celerite2_torch's fused log-likelihood (value and six cotangents)
against the JAX package, on CPU in float64.

The port's CPU route runs the plain PyTorch versions of the three scan
kernels with the same cross-block level, distribute and glue the CUDA
route uses.  The JAX side is the factor_solve pipeline on its scan tier
(``ll_ref``, as tests/test_fused_slab.py does) and, at one small
geometry, ``loglik_slab`` itself in Pallas interpret mode.  Tolerances
are test_fused_slab._check_parity's: value rtol 1e-10, cotangents
scaled atol 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celerite2_torch.ops.fused_loglik import kalman_fwd_plain, loglik_fused
from celerite2_tpu.ops import fused_slab
from celerite2_tpu.ops.fused_slab import loglik_slab
from torch_parity import (
    assert_rel_close,
    check_factor_adjoint_against_recursion,
    check_kalman_states_against_factor,
    check_parity,
    check_solve_rev_against_recursion,
    fused_pass_inputs,
    fused_system,
    jax_value_and_grads,
    ll_ref,
    t64,
    torch_value_and_grads,
)


@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [1, 2])
def test_against_factor_solve(N, J):
    args = fused_system(N, J=J)
    check_parity(torch_value_and_grads(args), jax_value_and_grads(ll_ref, args))


def test_against_loglik_slab_interpret():
    """N = 130, J = 2 against the JAX fused slab itself (interpret mode;
    larger geometries stay off tier-1, ROADMAP.md hazard C3)."""
    args = fused_system(130, J=2)
    check_parity(torch_value_and_grads(args), jax_value_and_grads(loglik_slab, args))


def test_kalman_states_against_slab_interpret():
    """The plain K1's (S, F) at N = 130, J = 2 against the S and F planes
    of the JAX fused slab's forward (``RES``, Pallas interpret mode)."""
    N, J = 130, 2
    args = fused_system(N, J=J)
    g = fused_slab.Geom(N, jnp.float64)
    RES = fused_slab._forward(g, *(jnp.asarray(x) for x in args))[3]
    planes = np.stack(
        fused_slab._unpack(g, [RES[:, :, e] for e in range(J * J + J)]), -1
    )
    p, U, V, ainv, y = fused_pass_inputs(args)["kalman_fwd"]
    S, F = kalman_fwd_plain(p, U, V, ainv, y, 256)
    assert_rel_close(S[0].numpy(), planes[:, : J * J].reshape(N, J, J), 1e-10, "S")
    assert_rel_close(F[0].numpy(), planes[:, J * J :], 1e-10, "F")


# K1's states through d, W, Z against ops.factor / ops.solve_lower, and K2's
# suffix states against the row recursion; L = 16 puts several blocks (a
# ragged last one at N = 65) under the cross-block level
@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [1, 2])
def test_kalman_states_against_factor(N, J, block_len):
    check_kalman_states_against_factor(fused_system(N, J=J), block_len)


@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [1, 2])
def test_solve_rev_states_against_recursion(N, J, block_len):
    check_solve_rev_against_recursion(fused_system(N, J=J), block_len)


# the factor adjoint's states MX from its plain routes (K3; K4 and K5)
# against the row recursion
@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [1, 2])
def test_factor_adjoint_states_against_recursion(N, J, block_len):
    check_factor_adjoint_against_recursion(fused_system(N, J=J), block_len)


@pytest.fixture(scope="module")
def ref_130():
    args = fused_system(130, J=2, seed=4)
    return args, jax_value_and_grads(ll_ref, args)


# L = 1: one row per block; 7: ragged last block; 65: two exact blocks;
# 130 = N: one block; 1000 > N: one ragged block
@pytest.mark.parametrize("block_len", [1, 7, 65, 130, 1000])
def test_block_lengths(ref_130, block_len):
    args, want = ref_130
    check_parity(torch_value_and_grads(args, block_len=block_len), want)


def test_chains_match_loop():
    """C = 3 chains with their own kernels, shared t: one batched call
    equals three single-chain calls (value and every cotangent)."""
    systems = [fused_system(100, J=2, sigma=s) for s in (0.7, 1.3, 2.1)]
    t = t64(systems[0][0]).requires_grad_(True)
    stacked = [
        torch.stack([t64(s[1 + i]) for s in systems]).requires_grad_(True)
        for i in range(5)
    ]
    ll = loglik_fused(t, *stacked, block_len=16)
    grads = torch.autograd.grad(ll.sum(), [t, *stacked])
    bt_sum = torch.zeros_like(t)
    for k in range(3):
        one = [x[k : k + 1].detach().requires_grad_(True) for x in stacked]
        tk = t.detach().clone().requires_grad_(True)
        llk = loglik_fused(tk, *one, block_len=16)
        gk = torch.autograd.grad(llk.sum(), [tk, *one])
        torch.testing.assert_close(ll[k], llk[0], rtol=1e-13, atol=0)
        for g, w in zip(grads[1:], gk[1:]):
            torch.testing.assert_close(g[k], w[0], rtol=1e-12, atol=1e-13)
        bt_sum += gk[0]
    torch.testing.assert_close(grads[0], bt_sum, rtol=1e-12, atol=1e-12)


def test_batched_times():
    """t of shape (C, N): each chain has its own times."""
    systems = [fused_system(90, J=1, seed=s) for s in range(2)]
    args = [
        torch.stack([t64(s[i]) for s in systems]).requires_grad_(True)
        for i in range(6)
    ]
    ll = loglik_fused(*args, block_len=8)
    grads = torch.autograd.grad(ll.sum(), args)
    for k, s in enumerate(systems):
        v, g = torch_value_and_grads(s, block_len=8)
        np.testing.assert_allclose(ll[k].item(), v, rtol=1e-13)
        for x0, x1 in zip(grads, g):
            np.testing.assert_allclose(x0[k].numpy(), x1, rtol=1e-12, atol=1e-13)


def test_nonpd_quiet_minus_inf():
    """A chain that is not positive definite gives -inf and zero
    gradients; its neighbour in the batch is unaffected."""
    bad = fused_system(80, nonpd=True)
    good = fused_system(80)
    args = [
        torch.stack([t64(bad[i]), t64(good[i])]).requires_grad_(True)
        for i in range(1, 6)
    ]
    ll = loglik_fused(t64(bad[0]), *args, block_len=16)
    assert np.isneginf(ll[0].item()) and np.isfinite(ll[1].item())
    grads = torch.autograd.grad(ll[0], args)
    for g in grads:
        assert torch.all(g[0] == 0)


@pytest.mark.parametrize("diag, yscale", [(-0.9, 1e15), (-0.999, 1e14)])
def test_float32_nonpd_overflow_is_quiet(diag, yscale):
    """A float32 chain that is not positive definite, with data so large
    that its Z^2 d^-2 overflows at a row whose pivot is positive (the
    NaN that 0 x inf gave in the backward before the non-PD chain's d and
    Z were masked, ROADMAP Queue C under D4): -inf, zero and finite
    gradients; the PD chain beside it as when it is alone."""
    from celerite2_torch import SHOTerm
    from celerite2_torch.ops import fused_loglik as fl

    rng = np.random.default_rng(0)
    N = 200
    t = torch.tensor(np.sort(rng.uniform(0, 10, N)), dtype=torch.float32)
    kernel = SHOTerm(sigma=torch.ones(2), rho=3.0, tau=2.0)
    c, a, U, V = kernel.get_celerite_matrices(
        t, torch.tensor([[0.04], [diag]]).expand(2, N))
    y = torch.tensor(rng.normal(size=(2, N)) * yscale, dtype=torch.float32)
    tt = t.expand(2, N).contiguous()
    with torch.no_grad():
        _, saved = fl._forward(tt, c, a, U, V, y, 32)
    dd, Z, ok = saved[-3:]
    assert ok.tolist() == [True, False]
    pos = dd[1] > 0
    assert torch.isinf((Z[1] / dd[1])[pos] ** 2).any()  # the overflow is reached
    args = [x.detach().clone().requires_grad_(True) for x in (c, a, U, V, y)]
    ll = loglik_fused(tt, *args, block_len=32)
    grads = torch.autograd.grad(ll.sum(), args)
    assert np.isneginf(ll[1].item()) and np.isfinite(ll[0].item())
    alone = [x[:1].detach().clone().requires_grad_(True) for x in (c, a, U, V, y)]
    grads0 = torch.autograd.grad(loglik_fused(tt[:1], *alone, block_len=32).sum(),
                                 alone)
    for g, g0 in zip(grads, grads0):
        assert torch.isfinite(g).all() and torch.all(g[1] == 0)
        assert torch.equal(g[:1], g0)


def test_width_and_shape_checks():
    t, c, a, U, V, y = (t64(x)[None] for x in fused_system(70))
    with pytest.raises(NotImplementedError, match="A3/A8"):
        loglik_fused(t[0], c.repeat(1, 4), a, U.repeat(1, 1, 4),
                     V.repeat(1, 1, 4), y)
    with pytest.raises(ValueError):
        loglik_fused(t[0], c, a, U, V, y[:, :-1])
