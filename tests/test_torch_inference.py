"""The port's inference modules other than the fleet sampler
(celerite2_torch.inference: diagnostics, transforms, adapt, fit, vi, smc)
against the JAX package's, float64 on the CPU, on the same numpy inputs
and on JAX's own random draws: diagnostics and adapt to 1e-12, ADVI and
the SMC stages to 1e-10, Adam's trace to 1e-10, L-BFGS on its optimum
(params within 1e-6, log-density within 1e-9 relative).  The whole ADVI
and SMC runs recover a Gaussian's moments as tests/test_inference.py
asks of the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch import inference as tinf
from celerite2_torch.inference import adapt as tadapt
from celerite2_torch.inference import smc as tsmc
from celerite2_tpu import GaussianProcess as JaxGP
from celerite2_tpu import inference as jinf
from celerite2_tpu import terms as jt
from celerite2_tpu.gp import gp_compute, gp_log_likelihood
from celerite2_tpu.inference import adapt as jadapt
from celerite2_tpu.inference import smc as jsmc
from torch_parity import assert_rel_close


@pytest.fixture(scope="module")
def gaussian():
    """tests/test_inference.py's Gaussian target in both packages."""
    dim = 3
    rng = np.random.default_rng(11)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T + dim * np.eye(dim)
    prec = np.linalg.inv(cov)
    mu = np.asarray([1.0, -2.0, 0.5])

    def jax_logp(q):
        r = q - jnp.asarray(mu)
        return -0.5 * r @ jnp.asarray(prec) @ r

    prec_t, mu_t = torch.tensor(prec), torch.tensor(mu)

    def logp(q):
        r = q - mu_t
        return -0.5 * ((r @ prec_t) * r).sum(-1)

    return jax_logp, logp, mu, cov


def ar1_draws(C, N, dim, seed, phi=0.7):
    rng = np.random.default_rng(seed)
    x = np.zeros((C, N, dim))
    x[:, 0] = rng.normal(size=(C, dim))
    for n in range(1, N):
        x[:, n] = phi * x[:, n - 1] + rng.normal(size=(C, dim))
    return x + rng.normal(size=(1, 1, dim))


# ---------------------------------------------------------- diagnostics


@pytest.mark.parametrize("N", [200, 201])
def test_diagnostics_against_jax(N):
    x = ar1_draws(4, N, 3, seed=N)
    got = tinf.summary(torch.tensor(x))
    want = jinf.summary(jnp.asarray(x))
    for key in ("mean", "sd", "q05", "q95", "ess", "rhat"):
        assert_rel_close(got[key].numpy(), np.asarray(want[key]), 1e-12, key)
    assert_rel_close(tinf.effective_sample_size(torch.tensor(x), max_lag=20).numpy(),
                     np.asarray(jinf.effective_sample_size(jnp.asarray(x), max_lag=20)),
                     1e-12, "ess max_lag=20")


def test_ess_runs_in_float64():
    x = ar1_draws(2, 100, 2, seed=3).astype(np.float32)
    ess = tinf.effective_sample_size(torch.tensor(x))
    assert ess.dtype == torch.float64
    assert_rel_close(ess.numpy(), np.asarray(jinf.effective_sample_size(jnp.asarray(x))),
                     1e-12, "ess")


# ----------------------------------------------------------- transforms


def test_transforms_against_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3))

    def jax_density(y):
        return -0.5 * jnp.sum((y - 1.0) ** 2)

    def density(y):
        return -0.5 * ((y - 1.0) ** 2).sum(-1)

    for jtr, ttr in ((jinf.IdentityTransform(), tinf.IdentityTransform()),
                     (jinf.LogTransform(), tinf.LogTransform())):
        want = jax.vmap(jinf.transform_logdensity(jax_density, jtr))(jnp.asarray(x))
        got = tinf.transform_logdensity(density, ttr)(torch.tensor(x))
        assert_rel_close(got.numpy(), np.asarray(want), 1e-12, type(ttr).__name__)
        y = ttr.forward(torch.tensor(x))
        assert_rel_close(ttr.inverse(y).numpy(), x, 1e-12)
        assert ttr.log_det_jacobian(torch.tensor(x)).shape == (5,)


# ---------------------------------------------------------------- adapt


def test_dual_averaging_against_jax():
    accepts = np.random.default_rng(0).uniform(size=20)
    js, ts = jadapt.da_init(jnp.asarray(0.3)), tadapt.da_init(torch.tensor(0.3, dtype=torch.float64))
    for a in accepts:
        js = jadapt.da_update(js, jnp.asarray(a), target=0.75)
        ts = tadapt.da_update(ts, torch.tensor(a), target=0.75)
    for name, g, w in zip(ts._fields, ts, js):
        assert_rel_close(g.numpy(), np.asarray(w), 1e-12, name)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_against_jax(dense):
    xs = np.random.default_rng(1).normal(size=(9, 4)) * [1.0, 2.0, 0.5, 3.0]
    js = jadapt.welford_init(4, jnp.float64, dense=dense)
    ts = tadapt.welford_init(4, torch.float64, dense=dense)
    for x in xs:
        js = jadapt.welford_update(js, jnp.asarray(x))
        ts = tadapt.welford_update(ts, torch.tensor(x))
    for name, g, w in zip(ts._fields, ts, js):
        assert_rel_close(g.numpy(), np.asarray(w), 1e-12, name)
    for regularize in (True, False):
        assert_rel_close(tadapt.welford_variance(ts, regularize=regularize).numpy(),
                         np.asarray(jadapt.welford_variance(js, regularize=regularize)),
                         1e-12, f"variance regularize={regularize}")


def test_mass_helpers_against_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 4))
    S = A @ A.T + 4 * np.eye(4)
    diag = rng.uniform(0.5, 2.0, 4)
    p = rng.normal(size=4)
    St = torch.tensor(S)
    assert_rel_close(tadapt.chol_small(St).numpy(), np.asarray(jadapt.chol_small(jnp.asarray(S))),
                     1e-12, "chol")
    for m in (S, diag):
        mt, mj = torch.tensor(m), jnp.asarray(m)
        assert_rel_close(tadapt.mass_matvec(mt, torch.tensor(p)).numpy(),
                         np.asarray(jadapt.mass_matvec(mj, jnp.asarray(p))), 1e-12)
        assert_rel_close(tadapt.mass_kinetic(mt, torch.tensor(p)).numpy(),
                         np.asarray(jadapt.mass_kinetic(mj, jnp.asarray(p))), 1e-12)
        # JAX's momentum from its key's normals, and the port's from the same
        key = jax.random.PRNGKey(7)
        z = np.asarray(jax.random.normal(key, (4,), jnp.float64))
        assert_rel_close(tadapt.mass_momentum(torch.tensor(z), mt).numpy(),
                         np.asarray(jadapt.mass_momentum(key, mj, jnp.float64)), 1e-12)
    # the dense momentum's covariance is inv(S), drawn from a generator
    ps = torch.stack([tadapt.mass_momentum(g, St) for g in
                      [torch.Generator().manual_seed(0)] * 4000])
    np.testing.assert_allclose(np.cov(ps.numpy().T), np.linalg.inv(S), atol=0.02)


@pytest.mark.parametrize("num_warmup", [1, 8, 60, 100, 500, 1000])
def test_build_schedule_against_jax(num_warmup):
    for got, want in zip(tadapt.build_schedule(num_warmup),
                         jadapt.build_schedule(num_warmup)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fit


def quadratic():
    mu = np.asarray([1.0, -2.0, 3.0])
    w = np.asarray([1.0, 4.0, 0.25])

    def jax_logp(x):
        return -0.5 * jnp.sum((x - jnp.asarray(mu)) ** 2 * jnp.asarray(w))

    def logp(x):
        return -0.5 * ((x - torch.tensor(mu)) ** 2 * torch.tensor(w)).sum(-1)

    return jax_logp, logp, np.zeros(3), 100


def sho_fit():
    """tests/test_fit_checkpoint.py's GP case (SHOTerm, N = 120)."""
    rng = np.random.default_rng(10)
    N = 120
    t = np.sort(rng.uniform(0, 20, N))
    yerr = np.full(N, 0.3)
    gp = JaxGP(jt.SHOTerm(sigma=1.2, rho=4.0, tau=3.0), t=t, yerr=yerr)
    y = np.asarray(gp.sample(jax.random.PRNGKey(2)))

    def jax_logp(theta):
        k = jt.SHOTerm(sigma=jnp.exp(theta[0]), rho=jnp.exp(theta[1]),
                       tau=jnp.exp(theta[2]))
        return gp_log_likelihood(gp_compute(k, t, yerr=yerr), y)

    tt, yt = torch.tensor(t), torch.tensor(y)

    def logp(theta):
        e = theta.exp()
        k = ct.SHOTerm(sigma=e[:, 0], rho=e[:, 1], tau=e[:, 2])
        return ct.gp_loglik(k, tt, yt, yerr=0.3)

    return jax_logp, logp, np.log([1.0, 3.0, 2.0]), 200


@pytest.mark.parametrize("case", [quadratic, sho_fit])
def test_fit_map_lbfgs_against_jax(case):
    jax_logp, logp, init, steps = case()
    want = jinf.fit_map(jax_logp, jnp.asarray(init), num_steps=steps)
    got = tinf.fit_map(logp, torch.tensor(init), num_steps=steps)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.log_prob.item(), float(want.log_prob), rtol=1e-9)
    assert got.trace.shape == (steps,) and got.trace[-1] >= got.trace[0]
    if case is quadratic:
        assert bool(got.converged) and bool(want.converged)


@pytest.mark.parametrize("case", [quadratic, sho_fit])
def test_fit_map_adam_against_optax(case):
    """The port's Adam against optax.adam, the optimiser the JAX
    package's fit_map(method="adam") names, run step by step on the same
    objective (that method of the JAX package raises before its first
    step: optax.value_and_grad_from_state reads L-BFGS's state)."""
    import optax

    jax_logp, logp, init, _ = case()
    steps, lr = 60, 0.05
    with pytest.raises(ValueError, match="not found in the state"):
        jinf.fit_map(jax_logp, jnp.asarray(init), num_steps=steps, method="adam")
    opt = optax.adam(lr)
    x = jnp.asarray(init)
    state = opt.init(x)
    value_and_grad = jax.jit(jax.value_and_grad(lambda x: -jax_logp(x)))
    trace = []
    for _ in range(steps):
        value, grad = value_and_grad(x)
        updates, state = opt.update(grad, state, x)
        x = optax.apply_updates(x, updates)
        trace.append(-float(value))
    got = tinf.fit_map(logp, torch.tensor(init), num_steps=steps, method="adam",
                       learning_rate=lr)
    assert_rel_close(got.trace.numpy(), np.asarray(trace), 1e-10, "trace")
    assert_rel_close(got.params.numpy(), np.asarray(x), 1e-10, "params")


def test_fit_map_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tinf.fit_map(lambda x: -(x**2).sum(-1), torch.zeros(2), method="sgd")


# ------------------------------------------------------------------- vi


def test_advi_against_jax(gaussian):
    """The port's ADVI on the normals JAX draws from split(key, num_steps)."""
    jax_logp, logp, _, _ = gaussian
    key, steps, M = jax.random.PRNGKey(1), 150, 8
    want = jinf.run_advi(jax_logp, jnp.zeros(3), key, num_steps=steps, num_mc_samples=M)
    draws = np.stack([np.asarray(jax.random.normal(k, (M, 3), jnp.float64))
                      for k in jax.random.split(key, steps)])
    got = tinf.run_advi(logp, torch.zeros(3, dtype=torch.float64), torch.tensor(draws),
                        num_steps=steps, num_mc_samples=M)
    assert_rel_close(got.elbo_trace.numpy(), np.asarray(want.elbo_trace), 1e-10, "elbo")
    assert_rel_close(got.mean.numpy(), np.asarray(want.mean), 1e-10, "mean")
    assert_rel_close(got.log_sigma.numpy(), np.asarray(want.log_sigma), 1e-10, "log_sigma")
    with pytest.raises(ValueError, match="shape"):
        tinf.run_advi(logp, torch.zeros(3, dtype=torch.float64), torch.tensor(draws),
                      num_steps=steps - 1)


def test_advi_gaussian(gaussian):
    """tests/test_inference.py's test_advi_gaussian through the port."""
    _, logp, mu, cov = gaussian
    res = tinf.run_advi(logp, torch.zeros(3, dtype=torch.float64),
                        torch.Generator().manual_seed(1), num_steps=1500)
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.2)
    sd = res.log_sigma.exp().numpy()
    assert np.all(sd > 0.3 * np.sqrt(np.diag(cov)))
    assert np.all(sd < 1.5 * np.sqrt(np.diag(cov)))
    elbo = res.elbo_trace.numpy()
    assert np.mean(elbo[-100:]) > np.mean(elbo[:100])
    assert res.sample(torch.Generator().manual_seed(0), (5,)).shape == (5, 3)


# ------------------------------------------------------------------ smc


def test_smc_stages_against_jax(gaussian):
    """Resampling, the next temperature and one HMC mutation on JAX's own
    draws."""
    jax_logp, logp, _, _ = gaussian
    rng = np.random.default_rng(4)
    P = 64
    particles = 3.0 * rng.normal(size=(P, 3))
    log_like = rng.normal(size=P) * 5.0 - 20.0
    key = jax.random.PRNGKey(3)

    want = jsmc._systematic_resample(key, jnp.asarray(log_like), jnp.asarray(particles))
    u0 = np.asarray(jax.random.uniform(key, ()))
    got = tsmc._systematic_resample(torch.tensor(u0), torch.tensor(log_like),
                                    torch.tensor(particles))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for beta in (0.0, 0.3, 0.97):
        want = jsmc._find_next_beta(jnp.asarray(log_like), jnp.asarray(beta))
        got = tsmc._find_next_beta(torch.tensor(log_like),
                                   torch.tensor(beta, dtype=torch.float64))
        assert_rel_close(got.numpy(), np.asarray(want), 1e-10, f"beta {beta}")

    scales = jnp.asarray([1.5, 0.7, 1.1])
    want_q, want_acc = jsmc._hmc_mutation(key, jnp.asarray(particles), jax_logp,
                                          jnp.asarray(1.2), scales, n_steps=7)
    pairs = [jax.random.split(k) for k in jax.random.split(key, P)]
    z = np.stack([np.asarray(jax.random.normal(k1, (3,), jnp.float64)) for k1, _ in pairs])
    u = np.stack([np.asarray(jax.random.uniform(k2, ())) for _, k2 in pairs])
    got_q, got_acc = tsmc._hmc_mutation(
        torch.tensor(particles), logp, torch.tensor(1.2, dtype=torch.float64),
        torch.tensor(np.asarray(scales)), torch.tensor(z), torch.tensor(u), n_steps=7)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    assert 0 < got_acc.sum() < P
    assert_rel_close(got_q.numpy(), np.asarray(want_q), 1e-10, "particles")


def test_smc_gaussian(gaussian):
    """tests/test_inference.py's test_smc_gaussian through the port."""
    _, logp, mu, cov = gaussian

    def log_prior(q):
        return -0.5 * (q**2).sum(-1) / 9.0

    def log_like(q):
        return logp(q) - log_prior(q)

    def sample_prior(gen, n):
        return 3.0 * torch.randn((n, 3), generator=gen, dtype=torch.float64)

    res = tinf.run_smc(log_prior, log_like, sample_prior, torch.Generator().manual_seed(2),
                       num_particles=2048, mutation_steps=15, mutation_eps=0.5)
    assert float(res.final_beta) == 1.0
    p = res.particles.numpy()
    np.testing.assert_allclose(p.mean(axis=0), mu, atol=0.35)
    np.testing.assert_allclose(p.std(axis=0), np.sqrt(np.diag(cov)), rtol=0.3)
    logZ_true = (1.5 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1]
                 - 1.5 * np.log(18 * np.pi))
    assert abs(float(res.log_evidence) - logZ_true) < 0.15
    assert float(res.mutation_eps) > 0 and int(res.n_stages) >= 1


# ------------------------------------------------------- checkpoints, observe


def test_save_restore_state(tmp_path):
    """A tree with a generator and NamedTuples survives a save: the
    restored generator draws what the saved one would have."""
    gen = torch.Generator().manual_seed(9)
    state = {"q": torch.arange(12.0).reshape(3, 4),
             "da": tadapt.da_init(torch.tensor(0.1, dtype=torch.float64)),
             "rng": gen, "step": 7}
    path = str(tmp_path / "ckpt.pt")
    tinf.save_state(path, state)
    restored = tinf.restore_state(path, template=state)
    assert torch.equal(restored["q"], state["q"]) and restored["step"] == 7
    assert isinstance(restored["da"], tadapt.DualAveragingState)
    assert all(torch.equal(a, b) for a, b in zip(restored["da"], state["da"]))
    assert torch.equal(torch.rand(5, generator=restored["rng"]), torch.rand(5, generator=gen))
    plain = tinf.restore_state(path)
    assert set(plain["da"]) == set(tadapt.DualAveragingState._fields)


def test_observe():
    from celerite2_torch.utils import observe
    from celerite2_tpu.utils import observe as jobserve

    for backend in ("scan", "assoc"):
        assert observe.roofline(1000, 4, backend=backend) == \
            observe.Roofline(**jobserve.roofline(1000, 4, backend=backend).__dict__)
    with observe.Timer(device="cpu") as timer:
        torch.ones(10).sum()
    assert timer.elapsed >= 0
    with observe.sampling_monitor(log_every=0) as (emit, records):
        emit(3, {"a": torch.tensor(1.5)})
    assert records == [(3, {"a": 1.5})]
