"""celerite2_torch's fused log-likelihood (value and six cotangents)
against the JAX package, on CPU in float64.

The port's CPU route runs the plain PyTorch versions of the three scan
kernels with the same cross-block level, distribute and glue the CUDA
route uses.  The JAX side is the factor_solve pipeline on its scan tier
(``_ll_ref``, as tests/test_fused_slab.py does) and, at one small
geometry, ``loglik_slab`` itself in Pallas interpret mode.  Tolerances
are test_fused_slab._check_parity's: value rtol 1e-10, cotangents
scaled atol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celerite2_torch.ops.fused_loglik import loglik_fused
from celerite2_tpu import ops as jops
from celerite2_tpu import terms as jt
from celerite2_tpu.ops.fused_slab import loglik_slab
from torch_parity import assert_scaled_close, jax_config, t64

NAMES = ["bt", "bc", "ba", "bU", "bV", "by"]


def _system(N, J=2, seed=0, nonpd=False, sigma=1.3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, N))
    if J == 1:
        kernel = jt.RealTerm(a=sigma - 0.2, c=0.7)
    else:
        kernel = jt.SHOTerm(sigma=sigma, rho=3.4, tau=2.9)
    diag = np.full(N, -2.0 if nonpd else 0.04)
    c, a, U, V = kernel.get_celerite_matrices(t, diag)
    y = np.sin(t) + 0.2 * rng.normal(size=N)
    return tuple(np.asarray(x) for x in (t, c, a, U, V, y))


def _ll_ref(t, c, a, U, V, y):
    d, _, z = jops.factor_solve(t, c, a, U, V, y[:, None])
    ok = jnp.all(d > 0)
    safe_d = jnp.where(d > 0, d, jnp.ones_like(d))
    ll = -0.5 * (
        jnp.sum(jnp.log(safe_d))
        + jnp.sum(z[:, 0] ** 2 / safe_d)
        + t.shape[0] * np.log(2 * np.pi)
    )
    return jnp.where(ok, ll, -jnp.inf)


def _jax_value_and_grads(fn, args):
    with jax_config(backend="scan", fused_slab="off"):
        jargs = tuple(jnp.asarray(x) for x in args)
        value = fn(*jargs)
        grads = jax.grad(fn, argnums=tuple(range(6)))(*jargs)
    return float(value), [np.asarray(g) for g in grads]


def _torch_value_and_grads(args, block_len=None):
    """The port on one chain: (t, c, a, U, V, y) gain the chain axis."""
    t, *rest = (t64(x).requires_grad_(True) for x in args)
    batched = [x[None] for x in rest]
    ll = loglik_fused(t, *batched, block_len=block_len)
    grads = torch.autograd.grad(ll.sum(), [t, *rest])
    return ll[0].item(), [g.numpy() for g in grads]


def _check(got, want):
    v0, g0 = got
    v1, g1 = want
    np.testing.assert_allclose(v0, v1, rtol=1e-10)
    for name, x0, x1 in zip(NAMES, g0, g1):
        assert x0.shape == x1.shape, name
        assert_scaled_close(x0, x1, 1e-9, name)


@pytest.mark.parametrize("N", [65, 130, 1040])
@pytest.mark.parametrize("J", [1, 2])
def test_against_factor_solve(N, J):
    args = _system(N, J=J)
    _check(_torch_value_and_grads(args), _jax_value_and_grads(_ll_ref, args))


def test_against_loglik_slab_interpret():
    """N = 130, J = 2 against the JAX fused slab itself (interpret mode;
    larger geometries stay off tier-1, ROADMAP.md hazard C3)."""
    args = _system(130, J=2)
    _check(_torch_value_and_grads(args), _jax_value_and_grads(loglik_slab, args))


@pytest.fixture(scope="module")
def ref_130():
    args = _system(130, J=2, seed=4)
    return args, _jax_value_and_grads(_ll_ref, args)


# L = 1: one row per block; 7: ragged last block; 65: two exact blocks;
# 130 = N: one block; 1000 > N: one ragged block
@pytest.mark.parametrize("block_len", [1, 7, 65, 130, 1000])
def test_block_lengths(ref_130, block_len):
    args, want = ref_130
    _check(_torch_value_and_grads(args, block_len=block_len), want)


def test_chains_match_loop():
    """C = 3 chains with their own kernels, shared t: one batched call
    equals three single-chain calls (value and every cotangent)."""
    systems = [_system(100, J=2, sigma=s) for s in (0.7, 1.3, 2.1)]
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
    systems = [_system(90, J=1, seed=s) for s in range(2)]
    args = [
        torch.stack([t64(s[i]) for s in systems]).requires_grad_(True)
        for i in range(6)
    ]
    ll = loglik_fused(*args, block_len=8)
    grads = torch.autograd.grad(ll.sum(), args)
    for k, s in enumerate(systems):
        v, g = _torch_value_and_grads(s, block_len=8)
        np.testing.assert_allclose(ll[k].item(), v, rtol=1e-13)
        for x0, x1 in zip(grads, g):
            np.testing.assert_allclose(x0[k].numpy(), x1, rtol=1e-12, atol=1e-13)


def test_nonpd_quiet_minus_inf():
    """A chain that is not positive definite gives -inf and zero
    gradients; its neighbour in the batch is unaffected."""
    bad = _system(80, nonpd=True)
    good = _system(80)
    args = [
        torch.stack([t64(bad[i]), t64(good[i])]).requires_grad_(True)
        for i in range(1, 6)
    ]
    ll = loglik_fused(t64(bad[0]), *args, block_len=16)
    assert np.isneginf(ll[0].item()) and np.isfinite(ll[1].item())
    grads = torch.autograd.grad(ll[0], args)
    for g in grads:
        assert torch.all(g[0] == 0)


def test_width_and_shape_checks():
    t, c, a, U, V, y = (t64(x)[None] for x in _system(70))
    with pytest.raises(NotImplementedError, match="B4/B5"):
        loglik_fused(t[0], c.repeat(1, 2), a, U.repeat(1, 1, 2),
                     V.repeat(1, 1, 2), y)
    with pytest.raises(ValueError):
        loglik_fused(t[0], c, a, U, V, y[:, :-1])
