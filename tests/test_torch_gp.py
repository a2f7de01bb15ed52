"""The port's main path as a whole: celerite2_torch.gp_loglik's value
and theta-gradient against celerite2_tpu.gp.gp_loglik under
jax.value_and_grad, in float64 on CPU: the fused path at J <= 4 and the
general factor_solve with its adjoints at J = 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.models import term_from_numpy
from celerite2_tpu import terms as jt
from celerite2_tpu.gp import gp_loglik as jax_gp_loglik
from torch_parity import assert_scaled_close, jax_config, spec_from_jax, t64


def _data(N, seed=3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, N))
    yerr = np.full(N, 0.2)
    y = np.sin(t) + 0.2 * rng.normal(size=N) + 0.3
    return t, yerr, y


# theta -> kernel, written once for both packages' term classes
def _sho(mod, th, exp):
    return mod.SHOTerm(sigma=exp(th[0]), rho=exp(th[1]), tau=exp(th[2]))


def _real(mod, th, exp):
    return mod.RealTerm(a=exp(th[0]), c=exp(th[1]))


def _sho_mixture(mod, th, exp):  # benchmarks/configs.py config5's J4 model
    return _sho(mod, th, exp) + mod.SHOTerm(
        sigma=exp(th[3]), rho=exp(th[4]), Q=0.3
    )


def _rotation(mod, th, exp):
    return mod.RotationTerm(sigma=exp(th[0]), period=exp(th[1]),
                            Q0=exp(th[2]), dQ=exp(th[3]), f=exp(th[4]))


def _matern_sho(mod, th, exp):
    return mod.Matern32Term(sigma=exp(th[0]), rho=exp(th[1])) + _sho(
        mod, th[2:], exp
    )


def _real_sho(mod, th, exp):
    return _real(mod, th, exp) + _sho(mod, th[2:], exp)


def _wide8(mod, th, exp):
    """A J = 8 model: four SHOTerms (benchmarks/probe_planes_tpu.py's wide
    model), the last one's Q = exp(th[3]) near critical damping."""
    k = _sho(mod, th, exp)
    for j in range(3):
        Q = exp(th[3]) if j == 2 else 0.3 + 0.1 * j
        k = k + mod.SHOTerm(sigma=exp(th[0]) * (0.5 + 0.2 * j),
                            rho=exp(th[1]) * (1.7 + j), Q=Q)
    return k


THETA8 = [0.1, 1.2, 1.0, np.log(0.5)]


MODELS = {
    "sho": (_sho, [0.1, 1.2, 1.0]),
    "real": (_real, [0.2, -0.4]),
    "sho_mixture": (_sho_mixture, [0.1, 1.2, 1.0, -0.5, 0.3]),
    "rotation": (_rotation, [0.2, 1.2, 0.3, 0.0, -0.7]),
    "matern_sho": (_matern_sho, [-0.2, 0.1, 0.1, 1.2, 1.0]),
    "real_sho": (_real_sho, [-0.5, 0.4, 0.1, 1.2, 1.0]),
}


@pytest.mark.parametrize("N", [300, 1040])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_value_and_theta_gradient(model, N):
    build, theta0 = MODELS[model]
    t, yerr, y = _data(N)
    mean = 0.25

    def jax_ll(th):
        return jax_gp_loglik(build(jt, th, jnp.exp), t, y, yerr=yerr, mean=mean)

    with jax_config(backend="scan", fused_slab="off"):
        v1, g1 = jax.value_and_grad(jax_ll)(jnp.asarray(theta0))

    th = torch.tensor(theta0, dtype=torch.float64, requires_grad=True)
    v0 = ct.gp_loglik(build(ct, th, torch.exp), t64(t), t64(y),
                      yerr=t64(yerr), mean=mean)
    (g0,) = torch.autograd.grad(v0, th)
    np.testing.assert_allclose(v0.item(), float(v1), rtol=1e-10)
    assert_scaled_close(g0.numpy(), np.asarray(g1), 1e-9, "theta")


@pytest.mark.parametrize("N", [65, 130, 1040])
def test_value_and_theta_gradient_at_j8(N):
    """J = 8 runs ops.factor_solve and, for the gradient, its adjoint (the
    lower solve's, then the factor's), as the JAX package does at J > 4."""
    t, yerr, y = _data(N, seed=N)

    def jax_ll(th):
        return jax_gp_loglik(_wide8(jt, th, jnp.exp), t, y, yerr=yerr, mean=0.25)

    with jax_config(backend="scan", fused_slab="off"):
        v1, g1 = jax.value_and_grad(jax_ll)(jnp.asarray(THETA8))
    th = torch.tensor(THETA8, dtype=torch.float64, requires_grad=True)
    kernel = _wide8(ct, th, torch.exp)
    assert kernel.width == 8
    v0 = ct.gp_loglik(kernel, t64(t), t64(y), yerr=t64(yerr), mean=0.25)
    (g0,) = torch.autograd.grad(v0, th)
    np.testing.assert_allclose(v0.item(), float(v1), rtol=1e-10)
    assert_scaled_close(g0.numpy(), np.asarray(g1), 1e-9, "theta")


def test_j8_chains_match_loop():
    """theta of shape (C, 4) at J = 8: one call through factor_solve with
    a chain axis against a loop over the chains."""
    t, yerr, y = _data(150)
    theta = torch.tensor([THETA8, [0.3, 0.5, -1.5, -0.2], [-0.2, 2.0, 0.4, -1.0]],
                         dtype=torch.float64, requires_grad=True)
    ll = ct.gp_loglik(_wide8(ct, theta.T, torch.exp), t64(t), t64(y), yerr=0.2)
    assert tuple(ll.shape) == (3,)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    for k in range(3):
        thk = theta[k].detach().clone().requires_grad_(True)
        llk = ct.gp_loglik(_wide8(ct, thk, torch.exp), t64(t), t64(y), yerr=0.2)
        (gk,) = torch.autograd.grad(llk, thk)
        torch.testing.assert_close(ll[k], llk, rtol=1e-12, atol=0)
        torch.testing.assert_close(g[k], gk, rtol=1e-10, atol=1e-12)


def test_j8_not_positive_definite_is_quiet():
    """A system that is not positive definite gives -inf and zero
    gradients, never NaN, at J = 8 as at J <= 4; a chain that is gives its
    own finite value and gradient beside it."""
    t, _, y = _data(300)
    theta = torch.tensor([THETA8, THETA8], dtype=torch.float64,
                         requires_grad=True)
    diag = torch.tensor([[-3.0], [0.04]], dtype=torch.float64)
    ll = ct.gp_loglik(_wide8(ct, theta.T, torch.exp), t64(t), t64(y), diag=diag)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    assert ll[0].item() == -np.inf and torch.all(g[0] == 0)
    assert torch.isfinite(ll[1]) and torch.isfinite(g[1]).all()
    assert torch.any(g[1] != 0)


def test_chains_match_loop():
    """theta of shape (C, 3): one call evaluates every chain."""
    t, yerr, y = _data(200)
    theta = torch.tensor(
        [[0.1, 1.2, 1.0], [0.3, 0.5, -1.5], [-0.2, 2.0, 0.4]],
        dtype=torch.float64, requires_grad=True,
    )
    kernel = _sho(ct, theta.T, torch.exp)
    ll = ct.gp_loglik(kernel, t64(t), t64(y), yerr=0.2)
    assert tuple(ll.shape) == (3,)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    for k in range(3):
        thk = theta[k].detach().clone().requires_grad_(True)
        llk = ct.gp_loglik(_sho(ct, thk, torch.exp), t64(t), t64(y), yerr=0.2)
        (gk,) = torch.autograd.grad(llk, thk)
        torch.testing.assert_close(ll[k], llk, rtol=1e-12, atol=0)
        torch.testing.assert_close(g[k], gk, rtol=1e-10, atol=1e-12)


def test_rotation_chains_match_loop():
    """RotationTerm parameters of shape (C,) through gp_loglik at J = 4:
    one call evaluates every chain."""
    t, yerr, y = _data(200)
    theta = torch.tensor(
        [[0.2, 1.2, 0.3, 0.0, -0.7], [0.0, 0.8, 0.6, -0.3, -1.2]],
        dtype=torch.float64, requires_grad=True,
    )
    ll = ct.gp_loglik(_rotation(ct, theta.T, torch.exp), t64(t), t64(y),
                      yerr=0.2)
    assert tuple(ll.shape) == (2,)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    for k in range(2):
        thk = theta[k].detach().clone().requires_grad_(True)
        llk = ct.gp_loglik(_rotation(ct, thk, torch.exp), t64(t), t64(y),
                           yerr=0.2)
        (gk,) = torch.autograd.grad(llk, thk)
        torch.testing.assert_close(ll[k], llk, rtol=1e-12, atol=0)
        torch.testing.assert_close(g[k], gk, rtol=1e-10, atol=1e-12)


def test_rotation_from_numpy():
    """A JAX RotationTerm carried across by term_from_numpy."""
    jterm = jt.RotationTerm(sigma=1.5, period=3.45, Q0=1.3, dQ=1.05, f=0.5)
    term = term_from_numpy(spec_from_jax(jterm))
    assert isinstance(term, ct.RotationTerm) and term.width == 4
    t, yerr, y = _data(150)
    with jax_config(backend="scan", fused_slab="off"):
        want = float(jax_gp_loglik(jterm, t, y, yerr=yerr))
    got = ct.gp_loglik(term, t64(t), t64(y), yerr=t64(yerr))
    np.testing.assert_allclose(got.item(), want, rtol=1e-10)


def test_term_from_numpy_matches_direct_construction():
    jterm = jt.SHOTerm(sigma=1.3, rho=3.4, tau=2.9) + jt.RealTerm(a=0.5, c=2.0)
    term = term_from_numpy(spec_from_jax(jterm))
    assert isinstance(term, ct.TermSum) and term.width == 3
    direct = ct.SHOTerm(sigma=1.3, rho=3.4, tau=2.9) + ct.RealTerm(a=0.5, c=2.0)
    t = t64(np.linspace(0, 5, 11))
    for g, w in zip(term.get_celerite_matrices(t, 0.1),
                    direct.get_celerite_matrices(t, 0.1)):
        torch.testing.assert_close(g, w, rtol=1e-14, atol=1e-14)
    f32 = term_from_numpy(spec_from_jax(jterm), dtype=torch.float32)
    assert f32.terms[0].w0.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="NoSuchTerm"):
        term_from_numpy({"type": "NoSuchTerm", "params": {}})


def test_argument_errors():
    t, yerr, y = _data(100)
    kernel = ct.SHOTerm(sigma=1.0, rho=2.0, tau=3.0)
    with pytest.raises(ValueError, match="only one of"):
        ct.gp_loglik(kernel, t64(t), t64(y), yerr=0.1, diag=0.01)
    # J = 8 under torch.no_grad(): the value alone, on the general factor
    # and solve
    sigma = t64(1.0).requires_grad_(True)
    wide = ct.SHOTerm(sigma=sigma, rho=2.0, tau=3.0) + kernel + kernel + kernel
    with torch.no_grad():
        got = ct.gp_loglik(wide, t64(t), t64(y), yerr=0.1)
    assert not got.requires_grad
    jk = jt.SHOTerm(sigma=1.0, rho=2.0, tau=3.0)
    with jax_config(backend="scan", fused_slab="off"):
        want = float(jax_gp_loglik(jk + jk + jk + jk, t, y, yerr=0.1))
    np.testing.assert_allclose(got.item(), want, rtol=1e-10)


def test_float64_core_dtype():
    """core_dtype='float64' computes in float64 from float32 inputs and
    returns float32 (the JAX package's f64 island)."""
    t, yerr, y = _data(150)
    th = torch.tensor([0.1, 1.2, 1.0], dtype=torch.float32, requires_grad=True)
    prior = ct.get_config()
    ct.set_config(core_dtype="float64")
    try:
        v32 = ct.gp_loglik(_sho(ct, th, torch.exp),
                           torch.tensor(t, dtype=torch.float32),
                           torch.tensor(y, dtype=torch.float32), diag=0.0625)
        (g32,) = torch.autograd.grad(v32, th)
    finally:
        ct.set_config(**prior.__dict__)
    assert v32.dtype == torch.float32 and g32.dtype == torch.float32
    th64 = th.detach().double().requires_grad_(True)
    v64 = ct.gp_loglik(_sho(ct, th64, torch.exp),
                       t64(np.float32(t)), t64(np.float32(y)), diag=0.0625)
    (g64,) = torch.autograd.grad(v64, th64)
    np.testing.assert_allclose(v32.item(), v64.item(), rtol=1e-7)
    np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=1e-6)
