"""The rest of the term DSL (products, second derivatives, boxcar
convolutions, wrapped celerite-v1 terms) against the JAX package's, in
float64: matrices, values, PSDs and dense matrices to 1e-12, torch
autograd against ``jax.grad``, ``gp_loglik`` value and gradient through a
J = 4 and a J = 8 product to 1e-9, the convolution's refusals, and the
citations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.models import term_from_numpy
from celerite2_tpu import citation as jcitation
from celerite2_tpu import terms as jt
from celerite2_tpu.gp import gp_loglik as jax_gp_loglik
from torch_parity import spec_from_jax, t64

RTOL = 1e-12


class V1Term:
    """A stand-in for a celerite-v1 term (the ``celerite`` package is not
    installed): one real and two complex components."""

    def get_all_coefficients(self):
        return (np.asarray([0.8]), np.asarray([0.4]), np.asarray([1.2, 0.5]),
                np.asarray([0.3, -0.1]), np.asarray([0.6, 1.4]),
                np.asarray([2.0, 0.7]))


def _sho():
    return jt.SHOTerm(sigma=1.3, rho=3.4, tau=2.9)


CASES = {
    "product_real_real": lambda: jt.RealTerm(a=1.5, c=0.7) * jt.RealTerm(a=0.4, c=1.1),
    "product_real_sho": lambda: jt.RealTerm(a=1.5, c=0.7) * _sho(),
    "product_sho_real": lambda: _sho() * jt.RealTerm(a=1.5, c=0.7),
    "product_sho_sho": lambda: _sho() * jt.SHOTerm(sigma=0.6, rho=1.1, Q=2.0),
    "product_over_under": lambda: jt.SHOTerm(S0=1.1, w0=2.0, Q=0.3) * _sho(),
    "product_rotation_sho": lambda: jt.RotationTerm(
        sigma=1.5, period=3.45, Q0=1.3, dQ=1.05, f=0.5) * _sho(),
    "product_of_sum": lambda: (_sho() + jt.RealTerm(a=0.4, c=1.7))
    * jt.ComplexTerm(a=1.5, b=0.7, c=0.7, d=0.5),
    "diff_real": lambda: jt.TermDiff(jt.RealTerm(a=1.5, c=0.7)),
    "diff_sum": lambda: jt.TermDiff(jt.RealTerm(a=0.4, c=1.7)
                                    + jt.ComplexTerm(a=1.5, b=0.7, c=0.7, d=0.5)),
    "diff_sho": lambda: jt.TermDiff(_sho()),
    "conv_real": lambda: jt.TermConvolution(jt.RealTerm(a=1.5, c=0.7), 0.5),
    "conv_sho": lambda: jt.TermConvolution(_sho(), 0.5),
    "conv_sum": lambda: jt.TermConvolution(
        jt.ComplexTerm(a=1.5, b=0.7, c=0.7, d=0.5) + jt.RealTerm(a=0.4, c=1.7), 0.8),
    "conv_matern": lambda: jt.TermConvolution(jt.Matern32Term(sigma=1.5, rho=2.3), 0.3),
    "original": lambda: jt.OriginalCeleriteTerm(V1Term()),
}

# the JAX package's SHOTerm gives its coefficients only for a concrete Q:
# these terms run there eagerly, but their width (taken by tracing) and
# their gradient are out of its reach
CONCRETE_Q = {"diff_sho", "conv_sho"}


def _inputs(seed=1, N=50):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, N))
    diag = rng.uniform(0.01, 0.1, N)
    return x, diag


def _close(got, want, rtol=RTOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_term_against_jax(case):
    """get_celerite_matrices, get_value (lags inside and beyond a
    convolution's window), get_psd and to_dense."""
    jterm = CASES[case]()
    term = term_from_numpy(spec_from_jax(jterm))
    assert type(term).__name__ == type(jterm).__name__
    x, diag = _inputs()
    want = jterm.get_celerite_matrices(x, diag)
    got = term.get_celerite_matrices(t64(x), t64(diag))
    for name, g, w in zip("caUV", got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, name=name)
    assert term.width == want[0].shape[0]
    if case not in CONCRETE_Q:
        assert jterm.width == term.width
    tau = np.linspace(-3.0, 12.0, 61)
    omega = np.linspace(0.0, 5.0, 33)
    _close(term.get_value(t64(tau)), jterm.get_value(tau), name="value")
    _close(term.get_psd(t64(omega)), jterm.get_psd(omega), name="psd")
    x, diag = _inputs(N=20)
    _close(term.to_dense(t64(x), t64(diag)), jterm.to_dense(x, diag), name="dense")


def torch_leaves(term):
    """The port term's parameter tensors in the JAX pytree's leaf order."""
    out = []
    for p in term._params:
        v = getattr(term, p)
        for item in (v if isinstance(v, tuple) else (v,)):
            out += torch_leaves(item) if isinstance(item, ct.Term) else [item]
    return out


# none of CONCRETE_Q
GRAD_CASES = ["product_real_sho", "product_sho_sho", "product_rotation_sho",
              "product_of_sum", "diff_sum", "conv_sum", "conv_matern", "original"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_matrix_gradients(case):
    """torch autograd of sum(U) + sum(a) + sum(c) against jax.grad, per
    parameter of the term tree."""
    jterm = CASES[case]()
    x, diag = _inputs(N=30)

    def jax_fn(k):
        c, a, U, _ = k.get_celerite_matrices(x, diag)
        return jnp.sum(U) + jnp.sum(a) + jnp.sum(c)

    want = jax.tree_util.tree_leaves(jax.grad(jax_fn)(jterm))
    term = term_from_numpy(spec_from_jax(jterm))
    leaves = torch_leaves(term)
    assert len(leaves) == len(want)
    for leaf in leaves:
        leaf.requires_grad_(True)
    c, a, U, _ = term.get_celerite_matrices(t64(x), t64(diag))
    got = torch.autograd.grad(U.sum() + a.sum() + c.sum(), leaves, allow_unused=True)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros(np.shape(w)) if g is None else g.numpy()
        scale = max(np.max(np.abs(np.asarray(w))), 1.0)
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("case,J", [("product_sho_sho", 4),
                                    ("product_rotation_sho", 8)])
def test_gp_loglik_through_products(case, J):
    """gp_loglik's value and gradient through a product term: J = 4 takes
    the fused path, J = 8 the general one."""
    jterm = CASES[case]()
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 20, 300))
    y = np.sin(t) + 0.3 * rng.normal(size=300)
    yerr = 0.3

    def jax_fn(k):
        return jax_gp_loglik(k, jnp.asarray(t), jnp.asarray(y), diag=yerr**2)

    want_v = float(jax_fn(jterm))
    want_g = jax.tree_util.tree_leaves(jax.grad(jax_fn)(jterm))
    term = term_from_numpy(spec_from_jax(jterm))
    assert term.width == J
    leaves = torch_leaves(term)
    for leaf in leaves:
        leaf.requires_grad_(True)
    ll = ct.gp_loglik(term, t64(t), t64(y), diag=yerr**2)
    got_g = torch.autograd.grad(ll, leaves, allow_unused=True)
    np.testing.assert_allclose(float(ll.detach()), want_v, rtol=1e-9)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        g = np.zeros(np.shape(w)) if g is None else g.numpy()
        scale = max(np.max(np.abs(np.asarray(w))), 1e-300)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=f"leaf {i}")


def test_batched_product_matches_loop():
    """Parameters of shape (C,) give C products equal to C unbatched ones."""
    sigma = t64([1.0, 1.3, 0.7])
    batched = ct.SHOTerm(sigma=sigma, rho=3.4, tau=2.9) * ct.SHOTerm(
        sigma=0.6, rho=1.1, Q=t64([2.0, 0.3, 0.9]))
    x = t64(np.linspace(0, 5, 13))
    mats = batched.get_celerite_matrices(x, 0.1)
    assert tuple(mats[2].shape) == (3, 13, 4)
    for i, Q in enumerate((2.0, 0.3, 0.9)):
        one = ct.SHOTerm(sigma=float(sigma[i]), rho=3.4, tau=2.9) * ct.SHOTerm(
            sigma=0.6, rho=1.1, Q=Q)
        for g, w in zip(mats, one.get_celerite_matrices(x, 0.1)):
            torch.testing.assert_close(g[i], w, rtol=0, atol=0)
    conv = ct.TermConvolution(ct.RealTerm(a=t64([1.0, 2.0]), c=0.5), t64([0.2, 0.4]))
    v = conv.get_value(t64(np.linspace(0, 1, 5)))
    assert tuple(v.shape) == (2, 5)
    for i, (a, d) in enumerate(((1.0, 0.2), (2.0, 0.4))):
        one = ct.TermConvolution(ct.RealTerm(a=a, c=0.5), d)
        torch.testing.assert_close(v[i], one.get_value(t64(np.linspace(0, 1, 5))))


@pytest.mark.parametrize("combine", [
    lambda mod, conv, k: conv + k,
    lambda mod, conv, k: k + conv,
    lambda mod, conv, k: conv * k,
    lambda mod, conv, k: k * conv,
    lambda mod, conv, k: mod.TermDiff(conv),
], ids=["sum", "sum_right", "product", "product_right", "diff"])
def test_convolution_must_be_outer(combine):
    """A convolution inside a sum, product or derivative is refused, as by
    the JAX package."""
    for mod in (ct, jt):
        conv = mod.TermConvolution(mod.RealTerm(a=1.0, c=0.5), 0.3)
        with pytest.raises(TypeError, match="outer term"):
            combine(mod, conv, mod.RealTerm(a=1.0, c=0.2))


def test_original_celerite_term():
    term = ct.OriginalCeleriteTerm(V1Term())
    assert term.width == 1 + 2 * 2
    for got, want in zip(term.get_coefficients(), V1Term().get_all_coefficients()):
        np.testing.assert_array_equal(got.numpy(), want)


def test_citations():
    assert ct.get_citations() == jcitation.get_citations()
    assert ct.get_citations("nope") == jcitation.get_citations("nope")
    assert ct.CITATION_KEYS == jcitation.CITATION_KEYS
    gp = ct.GaussianProcess(ct.SHOTerm(sigma=1.0, rho=2.0, tau=3.0),
                            t=np.linspace(0, 5, 10), yerr=0.1)
    keys, bib = gp.citations
    assert keys == ct.CITATION_KEYS and "celerite2:foremanmackey17" in bib
