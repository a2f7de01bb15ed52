"""celerite2_torch's fused log-likelihood at J = 3 and J = 4, where the
factor adjoint takes the structured route (K4 -> phase B -> K5), against
the JAX package on CPU in float64.

The JAX side is the factor_solve pipeline on its scan tier (``ll_ref``);
interpret-mode slab comparisons at J = 3..4 stay off tier-1 (ROADMAP.md
hazard C3).  Tolerances: value rtol 1e-10, cotangents scaled atol 1e-9
(test_fused_slab._check_parity's); the structured route against the dense
K3 route at J = 1, 2 to 1e-12, since both compute the same affine
recursion and differ only in rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celerite2_torch.ops import _build
from celerite2_torch.ops import elements as el
from celerite2_torch.ops import fused_loglik as fl
from celerite2_tpu.ops import planes
from torch_parity import (
    COTANGENTS,
    assert_scaled_close,
    check_factor_adjoint_against_recursion,
    check_kalman_states_against_factor,
    check_parity,
    check_solve_rev_against_recursion,
    fused_system,
    jax_value_and_grads,
    ll_ref,
    t64,
    torch_value_and_grads,
)


def _inverse_case(J, case, rng):
    M = rng.normal(size=(6, J, J)) + 2.0 * np.eye(J)
    if case == "zero_leading":
        # det of the leading block is 0 < fin.tiny: it is clamped
        M[:, :2, :2] = 0.0
    elif case == "singular_leading":
        # det 0 < eps (|ad| + |bc|): clamped to that floor
        M[:, :2, :2] = [[1.0, 2.0], [2.0, 4.0]]
    elif case == "zero_schur":
        # A = I and D = C B exactly, so the Schur complement is 0
        M[:, :2, :2] = np.eye(2)
        M[:, :2, 2:] = rng.integers(-3, 4, size=(6, 2, 2))
        M[:, 2:, :2] = rng.integers(-3, 4, size=(6, 2, 2))
        M[:, 2:, 2:] = M[:, 2:, :2] @ M[:, :2, 2:]
    return M


@pytest.mark.parametrize(
    "J, case",
    [(J, c) for J in (3, 4)
     for c in ("random", "zero_leading", "singular_leading")]
    + [(4, "zero_schur")],
)
def test_inv_clamped_matches_p_inv(J, case):
    """The bordered / Schur inverse against planes.p_inv, including the
    near-singular inputs where the determinant floor is hit."""
    M = _inverse_case(J, case, np.random.default_rng(J))
    got = el.inv_clamped(t64(M)).numpy()
    P = planes.mat_to_planes(jnp.asarray(M), J, J)
    want = np.asarray(planes.planes_to_mat(planes.p_inv(P, jnp.float64)))
    assert np.all(np.isfinite(got))
    assert_scaled_close(got, want, 1e-12, case)
    if case == "random":
        eye = np.broadcast_to(np.eye(J), M.shape)
        np.testing.assert_allclose(M @ got, eye, atol=1e-12)


@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [3, 4])
def test_against_factor_solve(N, J):
    args = fused_system(N, J=J)
    check_parity(torch_value_and_grads(args), jax_value_and_grads(ll_ref, args))


@pytest.fixture(scope="module")
def ref_130_j4():
    args = fused_system(130, J=4, seed=4)
    return args, jax_value_and_grads(ll_ref, args)


# L = 1: one row per block; 7: ragged last block; 65: two exact blocks;
# 130 = N: one block; 1000 > N: one ragged block
@pytest.mark.parametrize("block_len", [1, 7, 65, 130, 1000])
def test_block_lengths(ref_130_j4, block_len):
    args, want = ref_130_j4
    check_parity(torch_value_and_grads(args, block_len=block_len), want)


def test_chains_match_loop():
    """C = 3 chains at J = 4 with their own kernels, shared t: one
    batched call equals three single-chain calls."""
    systems = [fused_system(100, J=4, sigma=s) for s in (0.7, 1.3, 2.1)]
    t = t64(systems[0][0]).requires_grad_(True)
    stacked = [
        torch.stack([t64(s[1 + i]) for s in systems]).requires_grad_(True)
        for i in range(5)
    ]
    ll = fl.loglik_fused(t, *stacked, block_len=16)
    grads = torch.autograd.grad(ll.sum(), [t, *stacked])
    bt_sum = torch.zeros_like(t)
    for k in range(3):
        one = [x[k : k + 1].detach().requires_grad_(True) for x in stacked]
        tk = t.detach().clone().requires_grad_(True)
        llk = fl.loglik_fused(tk, *one, block_len=16)
        gk = torch.autograd.grad(llk.sum(), [tk, *one])
        torch.testing.assert_close(ll[k], llk[0], rtol=1e-13, atol=0)
        for g, w in zip(grads[1:], gk[1:]):
            torch.testing.assert_close(g[k], w[0], rtol=1e-12, atol=1e-13)
        bt_sum += gk[0]
    torch.testing.assert_close(grads[0], bt_sum, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("J", [3, 4])
def test_nonpd_quiet_minus_inf(J):
    """A J = 3, 4 chain that is not positive definite gives -inf and
    zero gradients; its neighbour in the batch is unaffected."""
    bad = fused_system(80, J=J, nonpd=True)
    good = fused_system(80, J=J)
    args = [
        torch.stack([t64(bad[i]), t64(good[i])]).requires_grad_(True)
        for i in range(1, 6)
    ]
    ll = fl.loglik_fused(t64(bad[0]), *args, block_len=16)
    assert np.isneginf(ll[0].item()) and np.isfinite(ll[1].item())
    grads = torch.autograd.grad(ll[0], args)
    for g in grads:
        assert torch.all(g[0] == 0)


def _factor_inputs(N, J, L, C=2):
    """The factor adjoint's inputs (p, U, W, bv0, bdp) on C chains."""
    systems = [fused_system(N, J=J, seed=s) for s in range(C)]
    args = [torch.stack([t64(s[i]) for s in systems]) for i in range(6)]
    return fl.pass_inputs(*args, block_len=L, structured=True)["frev_maps"]


# L = 16 with N = 300: a ragged last block; L = 300: one block
@pytest.mark.parametrize("L", [16, 300])
@pytest.mark.parametrize("J", [1, 2])
def test_structured_matches_dense(J, L):
    """At J = 1, 2 the structured route (K4 -> B -> K5) gives the dense
    K3 route's MX, and K4's block maps are K3's block maps (column k of
    the linear part at [k D, (k+1) D) against K3's row-major matrix)."""
    inputs = _factor_inputs(300, J, L)
    dense = fl.factor_adjoint(*inputs, L, structured=False)
    structured = fl.factor_adjoint(*inputs, L, structured=True)
    assert_scaled_close(structured.numpy(), dense.numpy(), 1e-12, "MX")

    D = J * J
    _, k3_maps = fl.factor_rev_blocks(*inputs, L)
    k4_maps = fl.frev_block_maps(*inputs, L)
    C, NB = k4_maps.shape[:2]
    k4_linear = k4_maps[..., : D * D].reshape(C, NB, D, D).mT
    k3_linear = k3_maps[..., : D * D].reshape(C, NB, D, D)
    assert_scaled_close(k4_linear.numpy(), k3_linear.numpy(), 1e-12, "A")
    assert_scaled_close(
        k4_maps[..., D * D :].numpy(), k3_maps[..., D * D :].numpy(), 1e-12, "b"
    )


@pytest.mark.parametrize("J", [1, 2])
def test_structured_cotangents_match_dense(J):
    """The six cotangents of the whole backward agree between the two
    routes at J = 1, 2."""
    args = [t64(x)[None] for x in fused_system(200, J=J, seed=5)]
    L = 16
    with torch.no_grad():
        ll, saved = fl._forward(*args, L)
        c = args[1]
        dense = fl._backward(c, saved, torch.ones_like(ll), L, structured=False)
        structured = fl._backward(c, saved, torch.ones_like(ll), L,
                                  structured=True)
    for name, g, w in zip(COTANGENTS, structured, dense):
        assert_scaled_close(g.numpy(), w.numpy(), 1e-12, name)


# (N, L): one block; one group of ten blocks; three groups of 32 blocks,
# the last group ragged (11 blocks) and its last block too (3 rows)
@pytest.mark.parametrize("N, L", [(95, 100), (95, 10), (299, 4)])
@pytest.mark.parametrize("J", [3, 4])
def test_frev_seeds_match_sequential_composition(J, N, L):
    """K4's suffixes within groups of 32 blocks and the groups' maps, and
    phase B's state entering each block, as loops over the block maps
    compose them: a block's suffix is its map after those of its group's
    later blocks, a group's map its first block's suffix, and the state
    entering a block every later block's map applied to the zero state."""
    inputs = _factor_inputs(N, J, L)
    maps = fl.frev_block_maps(*inputs, L)
    suffix, groups = fl.frev_maps_plain(*inputs, L)
    seeds = fl.frev_seeds(suffix, groups, J)
    D, G = J * J, _build.FUSED_GROUP
    C, NB = maps.shape[:2]
    assert suffix.shape == (C, NB, D * D + D)
    assert groups.shape == (C, -(-NB // G), D * D + D)
    A = maps[..., : D * D].reshape(C, NB, D, D).mT
    b = maps[..., D * D :, None]
    state = torch.zeros(C, D, 1, dtype=maps.dtype)
    for blk in range(NB - 1, -1, -1):
        torch.testing.assert_close(seeds[:, blk], state[..., 0], rtol=1e-12,
                                   atol=1e-14)
        state = A[:, blk] @ state + b[:, blk]
        if blk == NB - 1 or blk % G == G - 1:  # the last block of a group
            SA, Sb = A[:, blk], b[:, blk]
        else:
            SA, Sb = A[:, blk] @ SA, A[:, blk] @ Sb + b[:, blk]
        want = torch.cat([SA.flatten(-2), Sb[..., 0]], -1)
        assert_scaled_close(suffix[:, blk].numpy(), want.numpy(), 1e-13,
                            f"suffix {blk}")
        if blk % G == 0:
            assert_scaled_close(groups[:, blk // G].numpy(), want.numpy(),
                                1e-13, f"group {blk // G}")


# gp_loglik through the plain K4 and K5 with three groups of 32 blocks of 4
# rows (the last group and its last block ragged)
@pytest.mark.parametrize("J", [3, 4])
def test_groups_of_blocks_against_factor_solve(J):
    args = fused_system(299, J=J, seed=J)
    check_parity(torch_value_and_grads(args, block_len=4),
                 jax_value_and_grads(ll_ref, args))


# K1's states through d, W, Z against ops.factor / ops.solve_lower, and K2's
# suffix states against the row recursion, at J = 3, 4 (J = 1, 2:
# test_torch_fused_loglik.py)
@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [3, 4])
def test_kalman_states_against_factor(N, J, block_len):
    check_kalman_states_against_factor(fused_system(N, J=J), block_len)


@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [3, 4])
def test_solve_rev_states_against_recursion(N, J, block_len):
    check_solve_rev_against_recursion(fused_system(N, J=J), block_len)


# the factor adjoint's states MX from its plain routes (K3; K4 and K5)
# against the row recursion
@pytest.mark.parametrize("block_len", [None, 16])
@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [3, 4])
def test_factor_adjoint_states_against_recursion(N, J, block_len):
    check_factor_adjoint_against_recursion(fused_system(N, J=J), block_len)
