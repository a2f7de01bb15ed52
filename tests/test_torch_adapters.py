"""The adapters of celerite2_torch (``distributions.CeleriteNormal``, the
pymc cores of ``pymc_support``) against the JAX package's
(celerite2_tpu.distributions with ``_allow_without_numpyro``, and
celerite2_tpu.pymc_support's cores), float64 on the CPU: values to 1e-12
relative, gradients and VJPs to 1e-10, draws through the same normals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch import distributions as tdist
from celerite2_torch import pymc_support as tpm
import celerite2_tpu.distributions as jdist
import celerite2_tpu.pymc_support as jpm
from celerite2_tpu import GaussianProcess as JaxGP
from celerite2_tpu import terms as jt
from torch_parity import assert_rel_close, jax_config, t64

N = 60


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 10, N))
    yerr = np.full(N, 0.2)
    y = np.sin(t) + 0.1 * rng.normal(size=N)
    return t, yerr, y


def _sho(mod):
    return lambda sigma, rho, tau: mod.SHOTerm(sigma=sigma, rho=rho, tau=tau)


PARAMS = (1.5, 3.4, 2.345)


# ======================================================== CeleriteNormal


@pytest.fixture
def jax_normal(monkeypatch):
    if jdist.HAS_NUMPYRO:
        pytest.skip("numpyro present: the JAX adapter is numpyro's")
    monkeypatch.setattr(jdist.CeleriteNormal, "_allow_without_numpyro", True)
    return jdist.CeleriteNormal


def test_celerite_normal_against_jax(problem, jax_normal):
    """log_prob, the shapes, validate_args and the draws of one system."""
    t, yerr, y = problem
    with jax_config(backend="scan"):
        jgp = JaxGP(_sho(jt)(*PARAMS), t=t, yerr=yerr, mean=0.3)
    gp = ct.GaussianProcess(_sho(ct)(*PARAMS), t, yerr=yerr, mean=0.3)
    jd = jax_normal(jgp, validate_args=True)
    d = gp.distribution(torch.Generator().manual_seed(4), validate_args=True)
    assert isinstance(d, torch.distributions.Distribution)
    assert d.batch_shape == jd.batch_shape == ()
    assert tuple(d.event_shape) == tuple(jd.event_shape) == (N,)
    assert d.support is torch.distributions.constraints.real_vector
    assert d.arg_constraints == {}
    with jax_config(backend="scan"):
        want = float(jd.log_prob(jnp.asarray(y)))
    np.testing.assert_allclose(d.log_prob(y).item(), want, rtol=1e-12)
    np.testing.assert_allclose(tdist.gp_distribution(gp).log_prob(t64(y)).item(),
                               want, rtol=1e-12)
    for dist in (d, jd):
        with pytest.raises(ValueError, match="does not match event_shape"):
            dist.log_prob(np.zeros(N - 1))

    # a draw is L sqrt(d) z + mean of the generator's normals
    for shape in [(), (3,), (2, 3)]:
        d.generator.manual_seed(4)
        s = d.rsample(shape)
        assert s.shape == shape + (N,) and torch.isfinite(s).all()
    z = torch.randn(2, 3, N, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    with jax_config(backend="scan"):
        want = np.asarray(jgp.dot_tril(z.reshape(-1, N).numpy().T).T) + 0.3
    assert_rel_close(s.reshape(-1, N), want, 1e-12)
    # several values at once: one solve with a column each
    lp = d.log_prob(s)
    assert lp.shape == (2, 3)
    with jax_config(backend="scan"):
        jlp = jax.jit(jax.vmap(jd.log_prob))(jnp.asarray(s.reshape(-1, N).numpy()))
    assert_rel_close(lp.reshape(-1), np.asarray(jlp), 1e-12)
    # JAX's sample is numpyro-shaped too
    with jax_config(backend="scan"):
        assert jd.sample(jax.random.PRNGKey(0), (2, 3)).shape == (2, 3, N)


def test_celerite_normal_reparameterized_and_batched(problem):
    """rsample carries the gradient to the kernel's parameters, sample does
    not; a chain-axis state gives batch_shape (C,)."""
    t, yerr, y = problem
    sigma = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    gp = ct.GaussianProcess(ct.SHOTerm(sigma=sigma, rho=3.4, tau=2.345), t, yerr=yerr)
    d = tdist.CeleriteNormal(gp, generator=torch.Generator().manual_seed(1))
    (g,) = torch.autograd.grad(d.rsample((4,)).square().sum(), sigma)
    assert torch.isfinite(g) and g != 0
    assert not d.sample((4,)).requires_grad

    thetas = t64([[1.0, 3.0, 2.0], [1.4, 4.5, 2.8], [0.8, 2.2, 1.5]])
    state = ct.gp_compute(_sho(ct)(thetas[:, 0], thetas[:, 1], thetas[:, 2]), t,
                          yerr=yerr, mean=0.1)
    fleet = tdist.CeleriteNormal(state, torch.Generator().manual_seed(0),
                                 validate_args=True)
    assert fleet.batch_shape == (3,) and fleet.event_shape == (N,)
    s = fleet.rsample((2,))
    assert s.shape == (2, 3, N)
    lp = fleet.log_prob(s)
    assert lp.shape == (2, 3)
    for i in range(3):
        one = ct.gp_compute(_sho(ct)(*thetas[i]), t, yerr=yerr, mean=0.1)
        for k in range(2):
            np.testing.assert_allclose(lp[k, i].item(),
                                       ct.gp_log_likelihood(one, s[k, i]).item(),
                                       rtol=1e-12)
    assert_rel_close(fleet.log_prob(y), ct.gp_log_likelihood(state, y), 1e-14)


# ================================================================ pymc


def test_loglik_core_against_jax(problem):
    """Value, VJP (with the cotangent's scale) and array parameters."""
    t, yerr, y = problem
    core = tpm.LoglikCore(tpm.make_gp_loglik_fn(_sho(ct), t, y, yerr=yerr))
    jcore = jpm.LoglikCore(jpm.make_gp_loglik_fn(_sho(jt), t, y, yerr=yerr))
    with jax_config(backend="scan"):
        np.testing.assert_allclose(core.value(*PARAMS), jcore.value(*PARAMS), rtol=1e-12)
        for ct_ in (1.0, -2.0):
            got = core.grad(np.asarray(ct_), *PARAMS)
            want = jcore.grad(np.asarray(ct_), *PARAMS)
            assert len(got) == 3
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-10)

        def mk(mod):
            return lambda th: _sho(mod)(th[0], th[1], th[2])

        theta = np.asarray(PARAMS)
        (g,) = tpm.LoglikCore(tpm.make_gp_loglik_fn(mk(ct), t, y, yerr=yerr)).grad(
            np.asarray(1.0), theta)
        (w,) = jpm.LoglikCore(jpm.make_gp_loglik_fn(mk(jt), t, y, yerr=yerr)).grad(
            np.asarray(1.0), theta)
    assert g.shape == (3,)
    np.testing.assert_allclose(g, w, rtol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perform_contract(problem, dtype):
    """perform_* write into pytensor's output storage (lists of one-element
    lists) in the parameters' dtype, as the JAX package's do."""
    t, yerr, y = problem
    params = [dtype(p) for p in PARAMS]
    for mod, make in ((tpm, _sho(ct)), (jpm, _sho(jt))):
        core = mod.LoglikCore(mod.make_gp_loglik_fn(make, t, y, yerr=yerr))
        storage = [[None]]
        mod.perform_value(core, params, storage)
        assert storage[0][0].shape == () and storage[0][0].dtype == dtype
        gstorage = [[None], [None], [None]]
        mod.perform_grad(core, [np.asarray(1.0), *params], gstorage)
        for slot in gstorage:
            assert slot[0].dtype == dtype and np.isfinite(slot[0])
        if mod is tpm:
            mine = (storage[0][0], [s[0] for s in gstorage])
    np.testing.assert_allclose(mine[0], storage[0][0],
                               rtol=1e-12 if dtype == np.float64 else 1e-6)
    for a, b in zip(mine[1], (s[0] for s in gstorage)):
        np.testing.assert_allclose(a, b, rtol=1e-10 if dtype == np.float64 else 1e-4)


def test_quiet_minus_inf(problem):
    """A kernel that is not positive definite gives -inf, never NaN, and
    zero cotangents."""
    t, _, y = problem

    def mk(mod):
        return lambda a, c: mod.RealTerm(a=a, c=c)

    core = tpm.LoglikCore(tpm.make_gp_loglik_fn(mk(ct), t, y, diag=np.zeros_like(t)))
    jcore = jpm.LoglikCore(jpm.make_gp_loglik_fn(mk(jt), t, y, diag=np.zeros_like(t)))
    val = core.value(-25.0, 0.01)
    assert np.isneginf(val) and np.isneginf(jcore.value(-25.0, 0.01))
    assert all(g == 0 for g in core.grad(np.asarray(1.0), -25.0, 0.01))


def test_marginal_core_against_jax(problem):
    """logp(value, *params) and the prior draws' map: the JAX package's on
    the same normals, and affine in z with A A^T == the dense kernel."""
    t, yerr, y = problem
    core = tpm.MarginalCore(_sho(ct), t, yerr=yerr, mean=0.2)
    jcore = jpm.MarginalCore(_sho(jt), t, yerr=yerr, mean=0.2)
    with jax_config(backend="scan"):
        np.testing.assert_allclose(core.logp.value(y, *PARAMS),
                                   jcore.logp.value(y, *PARAMS), rtol=1e-12)
        for g, w in zip(core.logp.grad(np.asarray(1.0), y, *PARAMS),
                        jcore.logp.grad(np.asarray(1.0), y, *PARAMS)):
            np.testing.assert_allclose(g, w, rtol=1e-10)
        z = np.random.default_rng(0).normal(size=(3, N))
        want = np.asarray(jcore._draw(jnp.asarray(z), *map(jnp.asarray, PARAMS)))
    params = tuple(t64(p) for p in PARAMS)
    assert_rel_close(core._draw(t64(z), *params), want, 1e-12)

    A = torch.autograd.functional.jacobian(lambda z: core._draw(z[None], *params)[0],
                                           torch.zeros(N, dtype=torch.float64))
    K = _sho(ct)(*params).to_dense(t64(t), t64(yerr) ** 2)
    np.testing.assert_allclose((A @ A.T).numpy(), K.numpy(), rtol=1e-6, atol=1e-8)

    d = core.prior_draws(np.random.default_rng(0), None, *PARAMS)
    assert d.shape == (N,) and d.dtype == np.float64
    d2 = core.prior_draws(np.random.default_rng(0), (3, 2), *PARAMS)
    assert d2.shape == (3, 2, N) and np.all(np.isfinite(d2))
    again = core.prior_draws(np.random.default_rng(0), (3, 2), *PARAMS)
    np.testing.assert_array_equal(d2, again)


def _moments_cores(problem, component):
    t, yerr, y = problem
    t_new = np.linspace(-0.5, 10.5, 9)

    def mk(mod):
        return lambda s1, r1, s2, c2: (mod.SHOTerm(sigma=s1, rho=r1, tau=3.0)
                                       + mod.RealTerm(a=s2, c=c2))

    def comp(mod):
        return lambda s1, r1, s2, c2: mod.SHOTerm(sigma=s1, rho=r1, tau=3.0)

    kw = dict(t_new=t_new, yerr=yerr, mean=0.4, include_mean=not component)
    core = tpm.ConditionalMomentsCore(mk(ct), t, y, **kw,
                                      component=comp(ct) if component else None)
    jcore = jpm.ConditionalMomentsCore(mk(jt), t, y, **kw,
                                       component=comp(jt) if component else None)
    return core, jcore


@pytest.mark.parametrize("component", [False, True], ids=["full", "component"])
def test_conditional_moments_core_against_jax(problem, component):
    """values and the VJP against the JAX package's, and the condition()
    they come from; perform_moments(_grad) fill pytensor's storage."""
    t, yerr, y = problem
    core, jcore = _moments_cores(problem, component)
    params = (1.2, 2.5, 0.4, 0.9)
    mu, cov = core.values(*params)
    gmu = np.linspace(0.5, 1.0, core.m)
    gcov = np.eye(core.m) * 0.1
    got = core.vjp(gmu, gcov, *params)
    with jax_config(backend="scan"):
        jmu, jcov = jcore.values(*params)
        want = jcore.vjp(gmu, gcov, *params)
    assert core.m == jcore.m == 9
    assert_rel_close(mu, jmu, 1e-10, "mu")
    assert_rel_close(cov, jcov, 1e-10, "cov")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-12)

    kernel = (ct.SHOTerm(sigma=1.2, rho=2.5, tau=3.0) + ct.RealTerm(a=0.4, c=0.9))
    cond = ct.GaussianProcess(kernel, t, yerr=yerr, mean=0.4).condition(
        y, t=np.linspace(-0.5, 10.5, 9), include_mean=not component,
        kernel=kernel.terms[0] if component else None)
    assert_rel_close(mu, cond.mean.numpy(), 1e-12)
    assert_rel_close(cov, cond.covariance.numpy(), 1e-12)

    storage = [[None], [None]]
    tpm.perform_moments(core, [np.float64(p) for p in params], storage)
    assert storage[0][0].shape == (9,) and storage[1][0].shape == (9, 9)
    gstorage = [[None] for _ in params]
    tpm.perform_moments_grad(core, [gmu, gcov, *map(np.float64, params)], gstorage)
    assert all(np.isfinite(s[0]) and s[0].dtype == np.float64 for s in gstorage)


def test_vector_signature():
    for params in [(1.0, 2.0), (np.zeros(3),), (np.zeros((2, 2)), 1.0), ()]:
        assert tpm._vector_signature(params) == jpm._vector_signature(params)
    assert tpm._vector_signature((1.0, 2.0)) == "(),()->(n)"
    assert tpm._vector_signature((np.zeros(3),), "(m)") == "(p0d0)->(m)"


def test_gated_shell(problem):
    """Without pytensor the Ops are constructible (cores reachable) and
    their symbolic use raises the JAX package's ImportError; the model
    helpers need pymc."""
    t, yerr, y = problem
    op = tpm.celerite_loglik_op(_sho(ct), t, y, yerr=yerr)
    jop = jpm.celerite_loglik_op(_sho(jt), t, y, yerr=yerr)
    assert isinstance(op, tpm.CeleriteLoglikOp)
    assert np.isfinite(op.core.value(*PARAMS))
    assert tpm.HAS_PYTENSOR == jpm.HAS_PYTENSOR
    if tpm.HAS_PYTENSOR:
        pytest.skip("pytensor present: the real Ops are built")
    for a, b in ((op, jop),
                 (tpm.CeleriteConditionalMomentsOp(None),
                  jpm.CeleriteConditionalMomentsOp(None))):
        with pytest.raises(ImportError) as mine:
            a(*PARAMS)
        with pytest.raises(ImportError) as theirs:
            b(*PARAMS)
        assert str(mine.value).replace("celerite2_torch", "celerite2_tpu") == str(
            theirs.value)
    for helper in (lambda m: m.marginal_potential("x", None, (), t, y),
                   lambda m: m.marginal("x", None, (), t),
                   lambda m: m.conditional("x", None, (), t, y)):
        with pytest.raises(ImportError, match="pymc"):
            helper(tpm)
        with pytest.raises(ImportError, match="pymc"):
            helper(jpm)
