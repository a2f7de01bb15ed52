"""The port's GaussianProcess API (celerite2_torch.gp) against the JAX
package's (celerite2_tpu.gp), float64 on the CPU: the cases of
tests/test_gp.py run through both packages on the same numpy inputs.  The
composed GP calls agree to 1e-9 relative to each result's largest entry
(and each package is also held to the dense oracle at test_gp.py's own
tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.models import state_from_numpy, term_from_numpy
from celerite2_tpu import GaussianProcess as JaxGP
from celerite2_tpu import gp as jgp
from celerite2_tpu import terms as jt
from celerite2_tpu.utils import LinAlgError as JaxLinAlgError
from torch_parity import (
    WIDTHS, assert_rel_close, assert_scaled_close, jax_config, spec_from_jax, t64,
    wide_kernel,
)

RTOL = 1e-9


@pytest.fixture
def data():
    rng = np.random.default_rng(905)
    t = np.sort(rng.uniform(0, 10, 80))
    yerr = rng.uniform(0.1, 0.3, 80)
    y = np.sin(t) + yerr * rng.normal(size=80)
    return t, yerr, y


def _kernels():
    """test_gp.py's kernel in both packages."""
    jk = jt.SHOTerm(S0=1.3, w0=1.05, Q=3.0) + jt.RealTerm(a=0.5, c=0.8)
    tk = ct.SHOTerm(S0=1.3, w0=1.05, Q=3.0) + ct.RealTerm(a=0.5, c=0.8)
    return jk, tk


def _both(data, **kwargs):
    t, yerr, _ = data
    jk, tk = _kernels()
    with jax_config(backend="scan"):
        jax_gp = JaxGP(jk, t=t, yerr=yerr, **kwargs)
    return jax_gp, ct.GaussianProcess(tk, t, yerr=yerr, **kwargs)


def dense_loglike(K, y, mean=0.0):
    r = y - mean
    _, logdet = np.linalg.slogdet(K)
    return -0.5 * (logdet + r @ np.linalg.solve(K, r) + len(y) * np.log(2 * np.pi))


def _dense(data):
    t, yerr, _ = data
    return np.asarray(_kernels()[0].to_dense(t, yerr**2))


def test_log_likelihood(data):
    _, _, y = data
    jax_gp, gp = _both(data)
    want = float(jax_gp.log_likelihood(y))
    got = gp.log_likelihood(y)
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)
    np.testing.assert_allclose(got.item(), dense_loglike(_dense(data), y), rtol=1e-9)


@pytest.mark.parametrize("mean", [1.5, lambda x: 0.3 * x], ids=["constant", "callable"])
def test_mean_functions(data, mean):
    t, _, y = data
    jax_gp, gp = _both(data, mean=mean)
    np.testing.assert_allclose(gp.log_likelihood(y).item(),
                               float(jax_gp.log_likelihood(y)), rtol=RTOL)
    mval = mean(t) if callable(mean) else mean
    np.testing.assert_allclose(gp.log_likelihood(y).item(),
                               dense_loglike(_dense(data), y, mean=mval), rtol=1e-9)
    assert_rel_close(gp.mean_value, jax_gp.mean_value, 1e-14)


def test_yerr_diag_equivalence(data):
    t, yerr, y = data
    _, tk = _kernels()
    gp1 = ct.GaussianProcess(tk, t, yerr=yerr)
    gp2 = ct.GaussianProcess(tk, t, diag=yerr**2)
    np.testing.assert_allclose(gp1.log_likelihood(y).item(),
                               gp2.log_likelihood(y).item(), rtol=1e-12)
    with pytest.raises(ValueError, match="only one of"):
        ct.GaussianProcess(tk, t, yerr=yerr, diag=yerr**2)
    with pytest.raises(ValueError, match="only one of"):
        ct.gp_compute(tk, t, yerr=yerr, diag=yerr**2)


def test_apply_inverse_and_dot_tril(data):
    t, _, y = data
    jax_gp, gp = _both(data)
    K = _dense(data)

    x = gp.apply_inverse(y)
    assert x.shape == (80,)
    assert_rel_close(x, jax_gp.apply_inverse(y), RTOL)
    np.testing.assert_allclose(x, np.linalg.solve(K, y), rtol=1e-7, atol=1e-9)

    Ym = np.stack([y, 2 * y], axis=1)
    Xm = gp.apply_inverse(Ym)
    assert_rel_close(Xm, jax_gp.apply_inverse(Ym), RTOL)
    np.testing.assert_allclose(Xm, np.linalg.solve(K, Ym), rtol=1e-7, atol=1e-9)

    # dot_tril: z z^T reproduces K through the Cholesky identity
    z = gp.dot_tril(np.eye(len(t)))
    assert_rel_close(z, jax_gp.dot_tril(np.eye(len(t))), RTOL)
    np.testing.assert_allclose(z @ z.T, K, rtol=1e-7, atol=1e-9)
    assert_rel_close(gp.dot_tril(y), jax_gp.dot_tril(y), RTOL)


def test_predict_mean_var_cov(data):
    t, _, y = data
    jax_gp, gp = _both(data)
    K = _dense(data)
    jk, _ = _kernels()
    t_new = np.sort(np.random.default_rng(6).uniform(-1, 11, 45))
    Ks = np.asarray(jk.get_value(t_new[:, None] - t[None, :]))

    mu, var = gp.predict(y, t=t_new, return_var=True)
    mu2, cov = gp.predict(y, t=t_new, return_cov=True)
    jmu, jvar = jax_gp.predict(y, t=t_new, return_var=True)
    _, jcov = jax_gp.predict(y, t=t_new, return_cov=True)
    assert_rel_close(mu, jmu, RTOL, "mean")
    assert_rel_close(var, jvar, RTOL, "variance")
    assert_rel_close(cov, jcov, RTOL, "covariance")

    np.testing.assert_allclose(mu, Ks @ np.linalg.solve(K, y), rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(mu2, mu, rtol=1e-12)
    cov_exp = np.asarray(jk.get_value(t_new[:, None] - t_new[None, :])
                         ) - Ks @ np.linalg.solve(K, Ks.T)
    np.testing.assert_allclose(cov, cov_exp, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var, np.diag(cov_exp), rtol=1e-6, atol=1e-8)

    # the mean function is added at the new points, or left out
    jax_m, gp_m = _both(data, mean=lambda x: 0.3 * x)
    assert_rel_close(gp_m.predict(y, t=t_new), jax_m.predict(y, t=t_new), RTOL)
    assert_rel_close(gp_m.predict(y, t=t_new, include_mean=False),
                     jax_m.predict(y, t=t_new, include_mean=False), RTOL)


def test_predict_at_observed_fast_path(data):
    t, yerr, y = data
    jax_gp, gp = _both(data)
    K = _dense(data)
    mu = gp.predict(y)
    assert_rel_close(mu, jax_gp.predict(y), RTOL)
    np.testing.assert_allclose(
        mu, (K - np.diag(yerr**2)) @ np.linalg.solve(K, y), rtol=1e-7, atol=1e-9)
    assert_rel_close(gp.predict(y, include_mean=False),
                     jax_gp.predict(y, include_mean=False), RTOL)

    # per-kernel component prediction
    jk1 = jt.SHOTerm(S0=1.3, w0=1.05, Q=3.0)
    tk1 = ct.SHOTerm(S0=1.3, w0=1.05, Q=3.0)
    mu_k1 = gp.predict(y, kernel=tk1)
    assert_rel_close(mu_k1, jax_gp.predict(y, kernel=jk1), RTOL)
    K1 = np.asarray(jk1.to_dense(t, np.zeros_like(t)))
    np.testing.assert_allclose(mu_k1, K1 @ np.linalg.solve(K, y),
                               rtol=1e-6, atol=1e-8)


def test_error_contracts(data):
    t, yerr, y = data
    _, tk = _kernels()
    gp = ct.GaussianProcess(tk)
    with pytest.raises(RuntimeError, match="compute"):
        gp.log_likelihood(y)
    with pytest.raises(RuntimeError, match="compute"):
        gp.sample()
    with pytest.raises(ValueError, match="sorted"):
        gp.compute(t[::-1].copy(), yerr=yerr)
    with pytest.raises(ValueError, match="one dimensional"):
        gp.compute(np.stack([t, t]), yerr=yerr)
    gp.compute(t, yerr=yerr)
    with pytest.raises(ValueError, match="dimension mismatch"):
        gp.log_likelihood(y[:-1])
    with pytest.raises(ValueError, match="one dimensional"):
        gp.log_likelihood(np.stack([y, y], axis=1))
    with pytest.raises(ValueError, match="one-dimensional"):
        gp.condition(y, t=np.stack([t, t]))
    # a chain-axis kernel gives one state of two systems (the shell stays
    # one system), each equal to its own one-system state
    chains = ct.gp_compute(ct.RealTerm(a=t64([1.0, 2.0]), c=t64([0.5, 0.5])), t,
                           yerr=yerr)
    assert chains.d.shape == (2, len(t)) and chains.ok.shape == (2,)
    for i, a in enumerate((1.0, 2.0)):
        one = ct.gp_compute(ct.RealTerm(a=a, c=0.5), t, yerr=yerr)
        assert_rel_close(chains.W[i], one.W, 1e-14)
        np.testing.assert_allclose(chains.log_det[i].item(), one.log_det.item(),
                                   rtol=1e-14)
    with pytest.raises(ValueError, match="one system"):
        ct.GaussianProcess(ct.RealTerm(a=t64([1.0, 2.0]), c=t64([0.5, 0.5])), t)


def test_quiet_nonpd(data):
    t, yerr, y = data
    gp = ct.GaussianProcess(ct.RealTerm(a=-10.0, c=0.5))
    jax_gp = JaxGP(jt.RealTerm(a=-10.0, c=0.5))
    with pytest.raises(ct.LinAlgError, match="positive definite"):
        gp.compute(t, yerr=0.0 * yerr)
    with pytest.raises(JaxLinAlgError):
        jax_gp.compute(t, yerr=0.0 * yerr)
    gp.compute(t, yerr=0.0 * yerr, quiet=True)
    jax_gp.compute(t, yerr=0.0 * yerr, quiet=True)
    assert gp.log_likelihood(y).item() == -np.inf
    assert np.isneginf(float(jax_gp.log_likelihood(y)))
    st = gp.state
    assert not bool(st.ok) and st.log_det.item() == -np.inf
    assert st.norm.item() == np.inf and torch.isfinite(st.W).all()
    # recompute keeps the stored inputs and the quiet flag's meaning
    with pytest.raises(ct.LinAlgError):
        gp.recompute()
    assert gp.recompute(quiet=True).log_likelihood(y).item() == -np.inf


def test_functional_core_matches_shell_and_jax(data):
    t, yerr, y = data
    jk, tk = _kernels()
    with jax_config(backend="scan"):
        jstate = jgp.gp_compute(jk, t, yerr=yerr, mean=0.4)
        want = float(jgp.gp_log_likelihood(jstate, y))
    state = ct.gp_compute(tk, t, yerr=yerr, mean=0.4)
    np.testing.assert_allclose(ct.gp_log_likelihood(state, y).item(), want, rtol=RTOL)
    for name in ct.GPState._fields:
        assert_rel_close(getattr(state, name), np.asarray(getattr(jstate, name)),
                         RTOL, name)
    assert_rel_close(ct.gp_apply_inverse(state, y), jgp.gp_apply_inverse(jstate, y), RTOL)
    assert_rel_close(ct.gp_dot_tril(state, y), jgp.gp_dot_tril(jstate, y), RTOL)
    np.testing.assert_allclose(
        ct.gp_loglik(tk, t, y, yerr=yerr, mean=0.4).item(), want, rtol=RTOL)


def test_state_from_numpy_round_trip(data):
    """Factor in one package, solve in the other, both ways."""
    t, yerr, y = data
    jk, tk = _kernels()
    with jax_config(backend="scan"):
        jstate = jgp.gp_compute(jk, t, yerr=yerr, mean=0.4)
        want_ll = float(jgp.gp_log_likelihood(jstate, y))
        want_inv = np.asarray(jgp.gp_apply_inverse(jstate, y))
    fields = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    state = state_from_numpy(fields)
    assert state.ok.dtype == torch.bool and state.t.dtype == torch.float64
    assert all(x.device.type == "cpu" for x in state)
    np.testing.assert_allclose(ct.gp_log_likelihood(state, y).item(), want_ll, rtol=RTOL)
    assert_rel_close(ct.gp_apply_inverse(state, y), want_inv, RTOL)
    assert state_from_numpy(fields, dtype=torch.float32).W.dtype == torch.float32
    with pytest.raises(ValueError, match="missing fields"):
        state_from_numpy({k: v for k, v in fields.items() if k != "W"})

    # and back: the port's factorization solved by the JAX package
    mine = ct.gp_compute(tk, t, yerr=yerr, mean=0.4)
    back = jgp.GPState(**{k: jnp.asarray(v.numpy()) for k, v in mine._asdict().items()})
    with jax_config(backend="scan"):
        np.testing.assert_allclose(float(jgp.gp_log_likelihood(back, y)), want_ll,
                                   rtol=RTOL)
        assert_rel_close(jgp.gp_apply_inverse(back, y), want_inv, RTOL)


def test_prior_sample_moments(data):
    t, yerr, _ = data
    _, gp = _both(data, mean=2.0)
    # 16000 draws: the entries of K are near 4.6, so an empirical
    # covariance entry has a standard error near 0.05 against atol 0.25
    g = torch.Generator().manual_seed(0)
    samples = gp.sample(g, size=16000)
    assert samples.shape == (16000, len(t))
    K = _dense(data)
    emp_mean = samples.mean(0).numpy()
    emp_cov = np.cov(samples.numpy().T)
    np.testing.assert_allclose(emp_mean, 2.0 * np.ones(len(t)), atol=0.15)
    np.testing.assert_allclose(emp_cov, K, atol=0.25)
    assert gp.sample(g).shape == (len(t),)
    again = gp.sample(torch.Generator().manual_seed(0), size=16000)
    assert torch.equal(again, samples)
    centred = gp.sample(torch.Generator().manual_seed(0), size=16000, include_mean=False)
    assert_rel_close(centred + 2.0, samples, 1e-14)


def test_sample_is_the_jax_transform_of_the_same_noise(data):
    """Generators differ between the packages, so the same normals go
    through both: a sample is L sqrt(d) z plus the mean."""
    t, _, _ = data
    jax_gp, gp = _both(data, mean=2.0)
    z = np.random.default_rng(1).normal(size=(len(t), 5))
    assert_rel_close(gp.dot_tril(z), jax_gp.dot_tril(z), RTOL)


def test_conditional_sample_shape(data):
    t, _, y = data
    jax_gp, gp = _both(data)
    t_new = np.linspace(-1, 11, 20)
    cond = gp.condition(y, t=t_new)
    s = cond.sample(torch.Generator().manual_seed(1), shape=(7,), regularize=1e-10)
    assert s.shape == (7, 20) and torch.isfinite(s).all()
    js = jax_gp.condition(y, t=t_new).sample(
        jax.random.PRNGKey(1), shape=(7,), regularize=1e-10)
    assert js.shape == s.shape
    assert cond.sample(regularize=1e-10).shape == (20,)


@pytest.mark.parametrize("J", WIDTHS)
def test_every_method_at_width(J):
    """compute, log_likelihood, apply_inverse, dot_tril and predict (mean
    at the observed and at new points, variance) at widths 1 to 16."""
    rng = np.random.default_rng(J)
    t = np.sort(rng.uniform(0, 10, 90))
    yerr = rng.uniform(0.1, 0.3, 90)
    y = np.sin(t) + yerr * rng.normal(size=90)
    t_new = np.sort(rng.uniform(-1, 11, 33))
    jk = wide_kernel(jt, J)
    tk = term_from_numpy(spec_from_jax(jk))
    assert tk.width == J
    with jax_config(backend="scan"):
        jax_gp = JaxGP(jk, t=t, yerr=yerr, mean=0.2)
    gp = ct.GaussianProcess(tk, t, yerr=yerr, mean=0.2)
    np.testing.assert_allclose(gp.log_likelihood(y).item(),
                               float(jax_gp.log_likelihood(y)), rtol=RTOL)
    assert_rel_close(gp.apply_inverse(y), jax_gp.apply_inverse(y), RTOL)
    assert_rel_close(gp.dot_tril(y), jax_gp.dot_tril(y), RTOL)
    assert_rel_close(gp.predict(y), jax_gp.predict(y), RTOL)
    mu, var = gp.predict(y, t_new, return_var=True)
    jmu, jvar = jax_gp.predict(y, t=t_new, return_var=True)
    assert_rel_close(mu, jmu, RTOL, "mean")
    assert_rel_close(var, jvar, RTOL, "variance")


def test_float64_core_dtype_in_compute(data):
    """core_dtype='float64' factorizes in float64 from float32 inputs and
    returns a float32 state."""
    t, yerr, y = data
    _, tk = _kernels()
    t32, e32 = (torch.tensor(x, dtype=torch.float32) for x in (t, yerr))
    prior = ct.get_config()
    ct.set_config(core_dtype="float64")
    try:
        state = ct.gp_compute(tk, t32, yerr=e32)
    finally:
        ct.set_config(**prior.__dict__)
    assert state.d.dtype == torch.float32 and state.W.dtype == torch.float32
    exact = ct.gp_compute(tk, t32.double(), yerr=e32.double())
    assert_rel_close(state.d, exact.d, 1e-6)
    assert_rel_close(state.log_det, exact.log_det, 1e-6)


def _theta_kernel(mod, th, exp):
    """A J = 5 kernel (bucketed to 8) of theta: an SHOTerm, an overdamped
    SHOTerm and a RealTerm."""
    return (mod.SHOTerm(sigma=exp(th[0]), rho=exp(th[1]), tau=exp(th[2]))
            + mod.SHOTerm(sigma=0.6 * exp(th[0]), rho=1.1, Q=0.3)
            + mod.RealTerm(a=0.3, c=exp(th[3])))


THETA = [0.2, 0.4, 1.0, -0.3]
STATE_CALLS = ["log_likelihood", "apply_inverse", "dot_tril", "predict(y)",
               "predict(y, t_new)", "sample"]


def _state_call(name, gp, y, weights, noise, t_new, draw=None):
    """A scalar of the call's result: its dot product with fixed weights.
    ``draw`` is the sample's normals (the port draws them itself)."""
    if name == "log_likelihood":
        return gp.log_likelihood(y)
    if name == "apply_inverse":
        out = gp.apply_inverse(y)
    elif name == "dot_tril":
        out = gp.dot_tril(noise)
    elif name == "predict(y)":
        out = gp.predict(y)
    elif name == "predict(y, t_new)":
        out = gp.predict(y, t_new)
        return (weights[: len(t_new)] * out).sum()
    else:
        out = draw(gp)
    return (weights * out).sum()


@pytest.mark.parametrize("call", STATE_CALLS)
def test_gradients_through_the_state_api_match_jax(data, call):
    """The theta-gradient of each GaussianProcess call (through ops.factor,
    the sweeps and the rectangular products, with their adjoints) against
    jax.grad of the same call in the JAX package (scan tier), scaled 1e-9.
    A sample is L sqrt(d) z plus the mean: the port's draw from a seeded
    generator against the JAX transform of the same normals."""
    t, yerr, y = data
    rng = np.random.default_rng(17)
    weights = rng.normal(size=len(t))
    t_new = np.sort(rng.uniform(-1, 11, 30))
    z = torch.randn(len(t), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)

    def jax_value(th):
        gp = JaxGP(_theta_kernel(jt, th, jnp.exp), t=t, yerr=yerr, mean=0.2)
        return _state_call(call, gp, y, jnp.asarray(weights), np.asarray(z),
                           t_new, draw=lambda g: g.dot_tril(np.asarray(z)) + 0.2)

    with jax_config(backend="scan"):
        want = jax.grad(jax_value)(jnp.asarray(THETA))
    th = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    gp = ct.GaussianProcess(_theta_kernel(ct, th, torch.exp), t, yerr=yerr, mean=0.2)
    value = _state_call(
        call, gp, y, t64(weights), z, t_new,
        draw=lambda g: g.sample(torch.Generator().manual_seed(4)))
    (got,) = torch.autograd.grad(value, th)
    assert torch.isfinite(got).all() and torch.any(got != 0)
    assert_scaled_close(got.numpy(), np.asarray(want), 1e-9, call)


def test_gradients_through_the_functional_core(data):
    """gp_compute + gp_log_likelihood equal gp_loglik, value and gradient
    (the two routes through the general ops at J = 5)."""
    t, yerr, y = data
    th = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    state = ct.gp_compute(_theta_kernel(ct, th, torch.exp), t, yerr=yerr)
    ll = ct.gp_log_likelihood(state, y)
    (g1,) = torch.autograd.grad(ll, th)
    ll2 = ct.gp_loglik(_theta_kernel(ct, th, torch.exp), t, y, yerr=yerr)
    (g2,) = torch.autograd.grad(ll2, th)
    np.testing.assert_allclose(ll.item(), ll2.item(), rtol=1e-12)
    assert_rel_close(g1, g2, 1e-10)


def test_inputs_follow_the_default_device(data):
    """GaussianProcess, gp_compute and gp_loglik place numpy inputs on
    Config.device (shown with "meta", a device every build of PyTorch has:
    the kernel's checked wrapper then refuses the tensors instead of
    running the plain loop), and on the CPU when asked per call."""
    t, yerr, y = data
    _, tk = _kernels()
    prior = ct.get_config()
    ct.set_config(device="meta")
    try:
        with pytest.raises(ValueError, match="CUDA tensors, got meta"):
            ct.gp_compute(tk, t, yerr=yerr)
        with pytest.raises(ValueError, match="CUDA tensors, got meta"):
            ct.GaussianProcess(tk).compute(t, yerr=yerr, check_sorted=False)
        with pytest.raises(ValueError, match="CUDA tensors, got meta"):
            ct.gp_loglik(tk, t, y, yerr=yerr)
        state = ct.gp_compute(tk, t, yerr=yerr, device="cpu")
        gp = ct.GaussianProcess(tk, t, yerr=yerr, device="cpu")
        ll = ct.gp_loglik(tk, t, y, yerr=yerr, device="cpu")
    finally:
        ct.set_config(**prior.__dict__)
    assert all(x.device.type == "cpu" for x in state)
    np.testing.assert_allclose(gp.log_likelihood(y).item(), ll.item(), rtol=1e-12)
    # a tensor the caller passes keeps its own device
    assert ct.gp_compute(tk, t64(t), yerr=yerr).d.device.type == "cpu"
