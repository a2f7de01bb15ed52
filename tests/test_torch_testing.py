"""``celerite2_torch.testing`` against ``celerite2_tpu.testing``: the same
systems for the same seed, the term comparator on port terms, and the GP
surface over the port's tiers beside the JAX package's."""

import numpy as np
import pytest

import celerite2_torch as ct
from celerite2_tpu import terms as jt
from celerite2_tpu import testing as jtesting
from celerite2_torch import testing

ct.set_config(device="cpu")


@pytest.mark.parametrize("kwargs", [
    {}, {"vector": True}, {"conditional": True},
    {"conditional": True, "include_dense": True, "size": 60},
    {"no_diag": True, "include_dense": True, "seed": 5},
])
def test_get_matrices_matches_jax(kwargs):
    got, want = testing.get_matrices(**kwargs), jtesting.get_matrices(**kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-15)
    # the data (times, right-hand sides) come from the same generator
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[5], want[5])


def test_get_matrices_with_a_given_kernel():
    kernel = ct.SHOTerm(sigma=1.1, rho=3.3, tau=2.2) + ct.RealTerm(a=0.3, c=2.0)
    kernel_j = jt.SHOTerm(sigma=1.1, rho=3.3, tau=2.2) + jt.RealTerm(a=0.3, c=2.0)
    got = testing.get_matrices(size=40, kernel=kernel, conditional=True)
    want = jtesting.get_matrices(size=40, kernel=kernel_j, conditional=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)


def _pair(Q):
    """An SHOTerm and its coefficients as a plain Real or ComplexTerm."""
    sho = ct.SHOTerm(S0=1.3, w0=2.1, Q=Q)
    ar, cr, ac, bc, cc, dc = sho.get_coefficients()
    if Q < 0.5:
        other = ct.RealTerm(a=ar[0], c=cr[0]) + ct.RealTerm(a=ar[1], c=cr[1])
    else:
        other = ct.ComplexTerm(a=ac[0], b=bc[0], c=cc[0], d=dc[0])
    return sho, other


@pytest.mark.parametrize("Q", [0.3, 2.0])
def test_check_term_on_port_terms(Q):
    sho, other = _pair(Q)
    testing.check_term(sho, other)
    rot = ct.RotationTerm(sigma=1.2, period=3.5, Q0=2.0, dQ=1.0, f=0.3)
    testing.check_term(rot, ct.TermSum(*rot.terms))


def test_check_term_fails_on_different_terms():
    with pytest.raises(AssertionError):
        testing.check_term(ct.SHOTerm(S0=1.3, w0=2.1, Q=2.0),
                           ct.SHOTerm(S0=1.3, w0=2.2, Q=2.0))


@pytest.mark.parametrize("build", [
    lambda m: m.SHOTerm(sigma=1.5, rho=3.4, tau=2.345),
    lambda m: m.SHOTerm(sigma=1.0, rho=2.0, tau=1.5) + m.RealTerm(a=0.4, c=0.9),
    lambda m: m.RotationTerm(sigma=1.2, period=3.5, Q0=2.0, dQ=1.0, f=0.3),
], ids=["sho", "sho_real", "rotation"])
def test_check_gp_backends_on_port_terms(build):
    """The port's scan and assoc tiers agree over the GP surface, and with
    the JAX package's scan tier (all but the draws, whose generators
    differ; its assoc tier run op by op takes a minute a kernel)."""
    before = ct.get_config()
    got = testing.check_gp_backends(build(ct))
    assert set(got) == {"scan", "assoc"}
    assert ct.get_config() == before
    want = jtesting.check_gp_backends(build(jt), backends=("scan",))
    for name in ("loglike", "mean", "variance", "apply_inverse"):
        np.testing.assert_allclose(got["scan"][name], want["scan"][name], rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    assert got["scan"]["sample"].shape == want["scan"]["sample"].shape == (2, 120)
    assert np.all(np.isfinite(got["scan"]["sample"]))


def test_check_gp_backends_keeps_the_callers_config():
    before = ct.get_config()
    ct.set_config(backend="scan", assoc_threshold=7)
    try:
        testing.check_gp_backends(ct.SHOTerm(sigma=1.0, rho=2.0, tau=1.5), size=40)
        assert ct.get_config().backend == "scan"
        assert ct.get_config().assoc_threshold == 7
    finally:
        ct.set_config(backend=before.backend, assoc_threshold=before.assoc_threshold)


def test_check_gp_backends_fails_when_the_tiers_disagree(monkeypatch):
    """The comparator is not vacuous: a tier whose log-likelihood is off
    fails it."""
    from celerite2_torch import gp as gp_module

    real = gp_module.GaussianProcess.log_likelihood

    def off_on_assoc(self, y, **kw):
        out = real(self, y, **kw)
        return out + 1e-3 if ct.get_config().backend == "assoc" else out

    monkeypatch.setattr(gp_module.GaussianProcess, "log_likelihood", off_on_assoc)
    with pytest.raises(AssertionError, match="loglike"):
        testing.check_gp_backends(ct.SHOTerm(sigma=1.0, rho=2.0, tau=1.5), size=40)
