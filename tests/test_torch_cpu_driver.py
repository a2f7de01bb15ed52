"""The port's native CPU driver (``celerite2_torch.cpu``) against the JAX
package's (``celerite2_tpu.cpu``) on the same systems: the ten cases of
tests/test_cpu_driver.py.

Both build the same ``driver.cpp`` with the same flags, so the bindings
agree bit for bit; the eager GaussianProcess over the port's terms is held
against the JAX package's over its terms at that file's tolerances, and
against the port's own ``GaussianProcess`` on the CPU.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import celerite2_tpu as c2
import celerite2_torch as ct
from celerite2_tpu import terms as jt
from celerite2_tpu.testing import get_matrices
from celerite2_torch.cpu import NumpyGaussianProcess, bindings, driver
from celerite2_torch.utils import LinAlgError

jcpu = pytest.importorskip("celerite2_tpu.cpu")

ct.set_config(device="cpu")


@pytest.fixture(scope="module")
def system():
    return get_matrices(size=80, conditional=True)


def test_factor_matches_jax_driver(system):
    import jax.numpy as jnp

    from celerite2_tpu.ops import scan

    t, c, a, U, V, *_ = system
    d, W = driver.factor(t, c, a, U, V)
    d_j, W_j = jcpu.driver.factor(t, c, a, U, V)
    np.testing.assert_array_equal(d, d_j)
    np.testing.assert_array_equal(W, W_j)
    d_s, W_s, _ = scan.factor_scan(*map(jnp.asarray, (t, c, a, U, V)))
    np.testing.assert_allclose(d, d_s, rtol=1e-12)
    np.testing.assert_allclose(W, W_s, rtol=1e-10, atol=1e-13)


def test_sweeps_match_jax_driver(system):
    t, c, a, U, V, Y, *_ = system
    d, W = driver.factor(t, c, a, U, V)
    for name, (A, B) in (("solve_lower", (U, W)), ("solve_upper", (U, W)),
                         ("matmul_lower", (U, V)), ("matmul_upper", (U, V))):
        np.testing.assert_array_equal(getattr(driver, name)(t, c, A, B, Y),
                                      getattr(jcpu.driver, name)(t, c, A, B, Y),
                                      err_msg=name)
        # a vector right-hand side keeps its shape
        z = getattr(driver, name)(t, c, A, B, Y[:, 0])
        np.testing.assert_array_equal(z, getattr(jcpu.driver, name)(t, c, A, B, Y[:, 0]))


def test_general_matmul_matches_jax_driver(system):
    t, c, a, U, V, Y, t2, U2, V2 = system
    np.testing.assert_array_equal(driver.general_matmul_lower(t2, t, c, U2, V, Y),
                                  jcpu.driver.general_matmul_lower(t2, t, c, U2, V, Y))
    np.testing.assert_array_equal(driver.general_matmul_upper(t2, t, c, V2, U, Y),
                                  jcpu.driver.general_matmul_upper(t2, t, c, V2, U, Y))


def test_matrices_fill_matches_jax_driver_and_port_terms():
    # overdamped (real) term first so coefficient order == term order
    rng = np.random.default_rng(721)
    x = np.sort(rng.uniform(0, 10, 40))
    diag = rng.uniform(0.1, 0.3, 40)
    kernel = ct.SHOTerm(S0=1.0, w0=2.5, Q=0.2) + ct.SHOTerm(S0=5.0, w0=0.1, Q=3.45)
    kernel_j = jt.SHOTerm(S0=1.0, w0=2.5, Q=0.2) + jt.SHOTerm(S0=5.0, w0=0.1, Q=3.45)
    coeffs = [c.numpy() for c in kernel.get_coefficients()]
    coeffs_j = [np.asarray(c) for c in kernel_j.get_coefficients()]
    for got, want in zip(coeffs, coeffs_j):
        np.testing.assert_allclose(got, want, rtol=1e-14)
    got = driver.get_celerite_matrices(*coeffs, x, diag)
    for g, w in zip(got, jcpu.driver.get_celerite_matrices(*coeffs, x, diag)):
        np.testing.assert_array_equal(g, w)
    port = [m.numpy() for m in kernel.get_celerite_matrices(torch.tensor(x),
                                                            torch.tensor(diag))]
    for g, w in zip(got, port):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-13)


def test_factor_raises_on_nonpd(system):
    t, c, a, U, V, *_ = system
    with pytest.raises(LinAlgError):
        driver.factor(t, c, np.full_like(a, -1.0), U, V)


def test_inplace_outputs(system):
    t, c, a, U, V, *_ = system
    N, J = np.shape(U)
    d_buf, W_buf = np.empty(N), np.empty((N, J))
    d, W = driver.factor(t, c, a, U, V, d_out=d_buf, W_out=W_buf)
    assert d is d_buf and W is W_buf


def _data(seed, N):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, N))
    yerr = rng.uniform(0.1, 0.3, N)
    return t, yerr, np.sin(t) + yerr * rng.normal(size=N)


def test_numpy_gp_matches_jax_numpy_gp_and_port_gp():
    """The eager GP over port terms against the JAX package's over its
    terms (tests/test_cpu_driver.py's tolerances against the JAX GP), and
    against the port's GaussianProcess on the CPU."""
    t, yerr, y = _data(77, 120)
    t_new = np.linspace(-1, 11, 45)
    kernel = ct.SHOTerm(sigma=1.3, rho=3.1, tau=2.2) + ct.RealTerm(a=0.8, c=0.4)
    kernel_j = jt.SHOTerm(sigma=1.3, rho=3.1, tau=2.2) + jt.RealTerm(a=0.8, c=0.4)
    gp = NumpyGaussianProcess(kernel, t=t, yerr=yerr, mean=0.1)
    gp_j = jcpu.NumpyGaussianProcess(kernel_j, t=t, yerr=yerr, mean=0.1)
    ref = ct.GaussianProcess(kernel, t=t, yerr=yerr, mean=0.1)

    def np_(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for want in (gp_j, ref):
        np.testing.assert_allclose(gp.log_likelihood(y), float(want.log_likelihood(y)),
                                   rtol=1e-10)
        np.testing.assert_allclose(gp.apply_inverse(y), np_(want.apply_inverse(y)),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(gp.dot_tril(y), np_(want.dot_tril(y)),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(gp.predict(y), np_(want.predict(y)), rtol=1e-9,
                                   atol=1e-10)
        mu, var = gp.predict(y, t=t_new, return_var=True)
        mu_w, var_w = want.predict(y, t=t_new, return_var=True)
        np.testing.assert_allclose(mu, np_(mu_w), rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(var, np_(var_w), rtol=1e-7, atol=1e-9)
    # the covariance against the port's GaussianProcess: the JAX package's
    # eager predict(return_cov=True) raises (ROADMAP C10)
    _, cov = gp.predict(y, t=t_new, return_cov=True)
    _, cov_ref = ref.predict(y, t=t_new, return_cov=True)
    np.testing.assert_allclose(cov, cov_ref.numpy(), rtol=1e-7, atol=1e-9)

    # seeded prior draws: the JAX package's for the same generator
    s = gp.sample(size=4, rng=np.random.default_rng(0))
    assert s.shape == (4, 120) and np.all(np.isfinite(s))
    np.testing.assert_allclose(s, gp_j.sample(size=4, rng=np.random.default_rng(0)),
                               rtol=1e-9, atol=1e-11)


def test_numpy_gp_error_contract():
    t = np.linspace(0, 10, 50)
    gp = NumpyGaussianProcess(ct.RealTerm(a=-5.0, c=0.5))
    with pytest.raises(LinAlgError):
        gp.compute(t, yerr=np.full(50, 1e-6))
    gp.compute(t, yerr=np.full(50, 1e-6), quiet=True)
    assert gp.log_likelihood(np.sin(t)) == -np.inf
    with pytest.raises(ValueError):
        gp.compute(t[::-1])
    with pytest.raises(ValueError):
        gp.compute(t, yerr=np.ones(50), diag=np.ones(50))
    with pytest.raises(RuntimeError):
        NumpyGaussianProcess(ct.RealTerm(a=1.0, c=0.5)).log_likelihood(t)


def test_numpy_gp_convolution_override():
    """TermConvolution's diagonal correction goes through its own matrices,
    not the raw coefficient fill: the JAX package's value and the port's
    GaussianProcess."""
    t, _, _ = _data(3, 60)
    yerr, y = np.full(60, 0.2), np.sin(t)
    kernel = ct.TermConvolution(ct.SHOTerm(sigma=1.0, rho=2.0, tau=1.5), 0.08)
    kernel_j = jt.TermConvolution(jt.SHOTerm(sigma=1.0, rho=2.0, tau=1.5), 0.08)
    got = NumpyGaussianProcess(kernel, t=t, yerr=yerr).log_likelihood(y)
    np.testing.assert_allclose(
        got, jcpu.NumpyGaussianProcess(kernel_j, t=t, yerr=yerr).log_likelihood(y),
        rtol=1e-10)
    np.testing.assert_allclose(
        got, float(c2.GaussianProcess(kernel_j, t=t, yerr=yerr).log_likelihood(y)),
        rtol=1e-10)
    np.testing.assert_allclose(
        got, float(ct.GaussianProcess(kernel, t=t, yerr=yerr).log_likelihood(y)),
        rtol=1e-10)


def test_numpy_gp_sample_conditional():
    """Pathwise conditional draws: the JAX package's for the same
    generator, and the dense conditional's moments."""
    rng = np.random.default_rng(31)
    N, M = 64, 7
    t = np.sort(rng.uniform(0, 10, N))
    yerr = np.full(N, 0.25)
    y = np.sin(t) + yerr * rng.normal(size=N)
    t_new = np.linspace(1.0, 9.0, M)
    kernel = ct.SHOTerm(sigma=1.1, rho=3.3, tau=2.2)
    gp = NumpyGaussianProcess(kernel, t=t, yerr=yerr, mean=0.4)
    gp_j = jcpu.NumpyGaussianProcess(jt.SHOTerm(sigma=1.1, rho=3.3, tau=2.2), t=t,
                                     yerr=yerr, mean=0.4)

    samps = gp.sample_conditional(y, t=t_new, size=4000, rng=np.random.default_rng(5))
    assert samps.shape == (4000, M)
    np.testing.assert_allclose(
        samps, gp_j.sample_conditional(y, t=t_new, size=4000, rng=np.random.default_rng(5)),
        rtol=1e-8, atol=1e-10)

    K = kernel.to_dense(torch.tensor(t), torch.tensor(yerr**2)).numpy()
    Ks = kernel.get_value(torch.tensor(t_new[:, None] - t[None, :])).numpy()
    Kss = kernel.get_value(torch.tensor(t_new[:, None] - t_new[None, :])).numpy()
    mu = Ks @ np.linalg.solve(K, y - 0.4) + 0.4
    cov = Kss - Ks @ np.linalg.solve(K, Ks.T)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(samps.mean(axis=0), mu, atol=4.5 * sd.max() / np.sqrt(4000))
    np.testing.assert_allclose(np.cov(samps.T), cov, atol=6.0 * float(sd.max() ** 2) / 60.0)

    assert gp.sample_conditional(y, t=t_new, rng=np.random.default_rng(6)).shape == (M,)
    with pytest.raises(LinAlgError):
        gp.sample_conditional(y)  # t=None duplicates every time
    s2 = gp.sample_conditional(y, regularize=1e-8, rng=np.random.default_rng(7))
    assert s2.shape == (N,) and np.all(np.isfinite(s2))


def test_build_stays_in_the_ports_build_directory(tmp_path, monkeypatch):
    """The library is built into celerite2_torch/_build/ under a name
    hashed from the source and the flags, and nothing is written beside the
    source; a source that does not compile raises."""
    lib = bindings.build()
    pkg = Path(ct.__file__).resolve().parent
    assert lib.parent == pkg / "_build" and lib.exists()
    assert lib.name.startswith("libcelerite2_cpu_") and lib.suffix == ".so"
    beside = {p.name for p in (pkg / "cpu").iterdir() if p.name != "__pycache__"}
    assert beside == {"__init__.py", "bindings.py", "driver.cpp", "gp.py"}
    cmp = Path(c2.__file__).resolve().parent / "cpu" / "driver.cpp"
    assert (pkg / "cpu" / "driver.cpp").read_bytes() == cmp.read_bytes()

    bad = tmp_path / "driver.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bindings, "_SRC", bad)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bindings.build()
    assert not any((tmp_path / "build").iterdir())
