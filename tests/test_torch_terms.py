"""celerite2_torch's terms against the JAX package's, in float64.

The same numpy inputs go through both packages; matrices, kernel values
and PSDs agree to 1e-12, and torch autograd of the matrices agrees with
jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.models import term_from_numpy
from celerite2_tpu import terms as jt
from torch_parity import spec_from_jax, t64

RTOL = 1e-12

CASES = {
    "real": lambda: jt.RealTerm(a=1.5, c=0.7),
    "complex": lambda: jt.ComplexTerm(a=1.5, b=0.7, c=0.7, d=0.5),
    "sho_over": lambda: jt.SHOTerm(S0=1.1, w0=2.0, Q=0.3),
    "sho_under": lambda: jt.SHOTerm(sigma=1.3, rho=3.4, tau=2.9),
    "matern32": lambda: jt.Matern32Term(sigma=1.5, rho=2.345),
    "sum": lambda: jt.SHOTerm(sigma=1.3, rho=3.4, tau=2.9)
    + jt.RealTerm(a=0.4, c=1.7),
    "rotation": lambda: jt.RotationTerm(
        sigma=1.5, period=3.45, Q0=1.3, dQ=1.05, f=0.5
    ),
    "sho_mixture": lambda: jt.SHOTerm(sigma=1.0, rho=1.0, tau=1.0)
    + jt.SHOTerm(sigma=1.0, rho=1.0, Q=0.3),
}


def _inputs(seed=1, N=50):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, N))
    diag = rng.uniform(0.01, 0.1, N)
    return x, diag


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol, atol=rtol * np.max(np.abs(want))
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_celerite_matrices(case):
    jterm = CASES[case]()
    term = term_from_numpy(spec_from_jax(jterm))
    x, diag = _inputs()
    want = jterm.get_celerite_matrices(x, diag)
    got = term.get_celerite_matrices(t64(x), t64(diag))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    assert term.width == want[0].shape[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_value_psd_dense(case):
    jterm = CASES[case]()
    term = term_from_numpy(spec_from_jax(jterm))
    tau = np.linspace(-3.0, 12.0, 41)
    omega = np.linspace(0.0, 5.0, 33)
    _close(term.get_value(t64(tau)), jterm.get_value(tau))
    _close(term.get_psd(t64(omega)), jterm.get_psd(omega))
    x, diag = _inputs(N=20)
    _close(term.to_dense(t64(x), t64(diag)), jterm.to_dense(x, diag))


GRAD_CASES = ["real", "complex", "sho_over", "sho_under", "matern32",
              "rotation"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_matrix_gradients(case):
    """torch autograd of sum(U) + sum(a) against jax.grad, per parameter."""
    jterm = CASES[case]()
    names = jterm._params
    values = [float(getattr(jterm, p)) for p in names]
    x, diag = _inputs(N=30)
    cls = type(jterm)

    def jax_fn(*ps):
        _, a, U, _ = cls(**dict(zip(names, ps))).get_celerite_matrices(x, diag)
        return jnp.sum(U) + jnp.sum(a)

    want = jax.grad(jax_fn, argnums=tuple(range(len(names))))(*values)

    params = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in values]
    term = getattr(ct, cls.__name__)(**dict(zip(names, params)))
    _, a, U, _ = term.get_celerite_matrices(t64(x), t64(diag))
    got = torch.autograd.grad(U.sum() + a.sum(), params, allow_unused=True)
    for name, g, w in zip(names, got, want):
        g = 0.0 if g is None else g.item()
        np.testing.assert_allclose(g, float(w), rtol=RTOL, atol=RTOL, err_msg=name)


def test_batched_parameters_match_loop():
    """Parameters of shape (C,) give (C, N, J) matrices equal to C
    unbatched terms, across both SHO damping regimes."""
    Q = np.array([0.3, 0.45, 0.7, 2.5])
    w0 = np.array([1.1, 2.0, 0.8, 3.0])
    S0 = np.array([0.9, 1.3, 2.0, 0.5])
    x, diag = _inputs(N=40)
    batched = ct.SHOTerm(w0=t64(w0), Q=t64(Q), S0=t64(S0))
    mats = batched.get_celerite_matrices(t64(x), t64(diag))
    assert tuple(mats[2].shape) == (4, 40, 2)
    values = batched.get_value(t64(np.linspace(0, 5, 7)))
    assert tuple(values.shape) == (4, 7)
    for i in range(4):
        one = ct.SHOTerm(w0=float(w0[i]), Q=float(Q[i]), S0=float(S0[i]))
        for g, w in zip(mats, one.get_celerite_matrices(t64(x), t64(diag))):
            torch.testing.assert_close(g[i], w, rtol=0, atol=0)
        torch.testing.assert_close(
            values[i], one.get_value(t64(np.linspace(0, 5, 7))), rtol=0, atol=0
        )


def test_sho_clamp_keeps_gradients_finite():
    """At Q = 0.5 exactly both SHO branches are at their clamp; the
    gradient through torch.where stays finite (no 0 * inf)."""
    Q = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    term = ct.SHOTerm(w0=1.3, Q=Q, S0=0.8)
    _, a, U, _ = term.get_celerite_matrices(t64(np.linspace(0, 3, 9)), 0.0)
    (g,) = torch.autograd.grad(U.sum() + a.sum(), [Q])
    assert torch.isfinite(g)


def test_rotation_term_structure():
    """RotationTerm is two underdamped SHOTerms (at P and P/2), width 4,
    and takes a leading chain axis like every port term."""
    term = ct.RotationTerm(sigma=1.5, period=3.45, Q0=1.3, dQ=1.05, f=0.5)
    assert term.width == 4
    sho1, sho2 = term.terms
    assert isinstance(sho1, ct.SHOTerm) and isinstance(sho2, ct.SHOTerm)
    assert float(sho1.Q) > 0.5 and float(sho2.Q) > 0.5
    x, diag = _inputs(N=40)
    summed = (sho1 + sho2).get_celerite_matrices(t64(x), t64(diag))
    for g, w in zip(term.get_celerite_matrices(t64(x), t64(diag)), summed):
        torch.testing.assert_close(g, w, rtol=1e-13, atol=1e-13)

    period = np.array([2.0, 3.45, 7.1])
    batched = ct.RotationTerm(sigma=1.5, period=t64(period), Q0=1.3, dQ=1.05,
                              f=0.5)
    mats = batched.get_celerite_matrices(t64(x), t64(diag))
    assert tuple(mats[2].shape) == (3, 40, 4)
    for i, P in enumerate(period):
        one = ct.RotationTerm(sigma=1.5, period=float(P), Q0=1.3, dQ=1.05,
                              f=0.5)
        for g, w in zip(mats, one.get_celerite_matrices(t64(x), t64(diag))):
            torch.testing.assert_close(g[i], w, rtol=1e-14, atol=1e-14)
