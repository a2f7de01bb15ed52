"""The pathwise (Matheron) conditional sampler and the chain-axis GPState of
celerite2_torch.gp against the JAX package's (celerite2_tpu.gp), float64 on
the CPU.  The packages draw from different generators, so the same numpy
normals go through the noise-taking functions of both
(``_pathwise_core``, ``ConditionalDistribution._pathwise_transform``): the
draws agree to 1e-10 relative to their largest entry, and the law is
checked exactly through the Jacobian of the affine map (test_gp.py's slow
oracles, rtol 1e-6).  A fleet (a chain-axis state) equals its chains'
one-system calls to 1e-12 and the JAX package's ``jax.vmap`` of the same
functions to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch import gp as tgp
from celerite2_tpu import GaussianProcess as JaxGP
from celerite2_tpu import gp as jgp
from celerite2_tpu import terms as jt
from torch_parity import assert_rel_close, jax_config, t64

RTOL = 1e-10
N, M = 60, 13


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(905)
    t = np.sort(rng.uniform(0, 10, N))
    yerr = rng.uniform(0.1, 0.3, N)
    y = np.sin(t) + yerr * rng.normal(size=N)
    return t, yerr, y


def _kernels():
    """test_gp.py's kernel (a sum of an SHOTerm and a RealTerm) in both
    packages."""
    jk = jt.SHOTerm(S0=1.3, w0=1.05, Q=3.0) + jt.RealTerm(a=0.5, c=0.8)
    tk = ct.SHOTerm(S0=1.3, w0=1.05, Q=3.0) + ct.RealTerm(a=0.5, c=0.8)
    return jk, tk


def _conditionals(data, t_new, component, mean=1.5):
    t, yerr, y = data
    jk, tk = _kernels()
    with jax_config(backend="scan"):
        jgp_ = JaxGP(jk, t=t, yerr=yerr, mean=mean)
    gp = ct.GaussianProcess(tk, t, yerr=yerr, mean=mean)
    jcond = jgp_.condition(y, t=t_new, kernel=jk.terms[0] if component else None)
    cond = gp.condition(y, t=t_new, kernel=tk.terms[0] if component else None)
    return jcond, cond


def _noise(shape, component, seed=3):
    """The normals of one draw: ``(z, eps, z_comp)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape + (N + M,))
    eps = rng.normal(size=shape + (N,))
    z_comp = rng.normal(size=shape + (N,)) if component else None
    return z, eps, z_comp


@pytest.mark.parametrize("component", [False, True], ids=["full", "component"])
def test_pathwise_transform_matches_jax(data, component):
    """The port's _pathwise_transform against the JAX package's on the same
    (z, eps[, z_comp]), batch shape (5,)."""
    t_new = np.linspace(-0.5, 10.5, M)
    jcond, cond = _conditionals(data, t_new, component)
    z, eps, z_comp = _noise((5,), component)
    with jax_config(backend="scan"):
        want = jax.jit(jcond._pathwise_transform)(
            jnp.asarray(z), jnp.asarray(eps),
            z_comp=None if z_comp is None else jnp.asarray(z_comp))
    got = cond._pathwise_transform(z, eps, z_comp=z_comp)
    assert got.shape == (5, M) and got.dtype == torch.float64
    assert_rel_close(got, np.asarray(want), RTOL)


@pytest.mark.parametrize("component", [False, True], ids=["full", "component"])
def test_pathwise_exact_moments(data, component):
    """The draws are affine in their noise: the map at zero noise is the
    conditional mean, and its Jacobian A gives A A^T == the covariance (the
    port's and the JAX package's), with no Monte Carlo error."""
    t_new = np.linspace(-0.5, 10.5, M)
    jcond, cond = _conditionals(data, t_new, component, mean=0.7)
    n_comp = N if component else 0

    def draw(noise):
        z, zc, eps = (noise[: N + M], noise[N + M: N + M + n_comp],
                      noise[N + M + n_comp:])
        return cond._pathwise_transform(z, eps, z_comp=zc if component else None)

    zero = torch.zeros(2 * N + M + n_comp, dtype=torch.float64)
    assert_rel_close(draw(zero), cond.mean, 1e-9, "mean")
    A = torch.autograd.functional.jacobian(draw, zero)
    assert A.shape == (M, zero.shape[0])
    implied = (A @ A.T).numpy()
    np.testing.assert_allclose(implied, cond.covariance.numpy(), rtol=1e-6, atol=1e-8)
    with jax_config(backend="scan"):
        jcov = np.asarray(jax.jit(lambda: jcond.covariance)())
    np.testing.assert_allclose(implied, jcov, rtol=1e-6, atol=1e-8)


def test_duplicated_targets_with_regularize(data):
    """Targets that repeat training times need the joint jitter: the draws
    are finite, shaped, and the JAX package's on the same noise."""
    t, _, _ = data
    t_new = np.sort(np.concatenate([t[::7], np.linspace(2.0, 8.0, 4)]))
    assert len(t_new) == M
    jcond, cond = _conditionals(data, t_new, False)
    s = cond.sample_pathwise(torch.Generator().manual_seed(3), shape=(6,),
                             regularize=1e-8)
    assert s.shape == (6, M) and torch.isfinite(s).all()
    z, eps, _ = _noise((6,), False)
    with jax_config(backend="scan"):
        want = jax.jit(lambda z, e: jcond._pathwise_transform(z, e, regularize=1e-8))(
            jnp.asarray(z), jnp.asarray(eps))
    got = cond._pathwise_transform(z, eps, regularize=1e-8)
    # the jitter leaves pivots near 1e-8, whose digits the two packages'
    # factors round differently: 1e-10 of the largest draw is kept
    assert_rel_close(got, np.asarray(want), RTOL)


def test_singular_joint_prior_without_regularize(data):
    """Without the jitter, targets that repeat training times make the
    joint prior singular: its pivots there are rounding noise (+-1e-15),
    and which of them fall at or below zero differs between the packages.
    Both apply the same rule (such a pivot adds nothing to the draw, and
    its W divides by 1), so the draws are finite and agree to 1e-7 of the
    largest, not to 1e-10 (ROADMAP D9)."""
    t, _, _ = data
    t_new = np.sort(np.concatenate([t[::7], np.linspace(2.0, 8.0, 4)]))
    jcond, cond = _conditionals(data, t_new, False)
    z, eps, _ = _noise((5,), False)
    with jax_config(backend="scan"):
        want = jax.jit(jcond._pathwise_transform)(jnp.asarray(z), jnp.asarray(eps))
    got = cond._pathwise_transform(z, eps)
    assert torch.isfinite(got).all() and np.isfinite(np.asarray(want)).all()
    assert_rel_close(got, np.asarray(want), 1e-7)


def test_near_duplicate_targets_keep_the_law_in_both_packages(data):
    """Two targets 1e-7 from training times under a smooth kernel (config5's
    mixture of two SHOTerms): the joint prior's pivots there fall below
    float64's resolution, so the map from the normals to the draws is not
    determined to 1e-10 (the two packages' maps differ by about 5e-5 of
    their largest entry) while the law is: the map's columns A, read by
    the affine map at unit normals, give A A^T equal to the covariance in
    both packages (ROADMAP C8)."""
    t, yerr, y = data
    t_new = np.sort(np.concatenate([np.linspace(-0.5, 10.5, M - 2),
                                    t[[20, 40]] + 1e-7]))
    jk = jt.SHOTerm(sigma=1.0, rho=1.0, tau=1.0) + jt.SHOTerm(sigma=1.0, rho=1.0, Q=0.3)
    tk = ct.SHOTerm(sigma=1.0, rho=1.0, tau=1.0) + ct.SHOTerm(sigma=1.0, rho=1.0, Q=0.3)
    with jax_config(backend="scan"):
        jcond = JaxGP(jk, t=t, yerr=yerr, mean=1.5).condition(y, t=t_new)
    cond = ct.GaussianProcess(tk, t, yerr=yerr, mean=1.5).condition(y, t=t_new)
    cov = cond.covariance.numpy()
    unit = np.concatenate([np.zeros((1, 2 * N + M)), np.eye(2 * N + M)])
    got = cond._pathwise_transform(unit[:, :N + M], unit[:, N + M:]).numpy()
    with jax_config(backend="scan"):
        want = np.asarray(jax.jit(lambda n: jcond._pathwise_transform(
            n[:, :N + M], n[:, N + M:]))(jnp.asarray(unit)))
    for draws in (got, want):
        A = (draws[1:] - draws[0]).T
        assert_rel_close(A @ A.T, cov, 1e-12)


def test_sample_pathwise_draws_in_order(data):
    """sample_pathwise draws z, then the complement's normals, then eps,
    from its generator: the same seed through _pathwise_transform gives the
    same draws; a derived complement equals one passed explicitly."""
    t_new = np.linspace(-0.5, 10.5, M)
    _, tk = _kernels()
    for component in (False, True):
        _, cond = _conditionals(data, t_new, component)
        got = cond.sample_pathwise(torch.Generator().manual_seed(8), shape=(2, 3))
        g = torch.Generator().manual_seed(8)
        z = torch.randn(2, 3, N + M, generator=g, dtype=torch.float64)
        zc = torch.randn(2, 3, N, generator=g, dtype=torch.float64) if component else None
        eps = torch.randn(2, 3, N, generator=g, dtype=torch.float64)
        want = cond._pathwise_transform(z, eps, z_comp=zc)
        assert got.shape == (2, 3, M)
        assert torch.equal(got, want)
    again = cond.sample_pathwise(torch.Generator().manual_seed(8), shape=(2, 3),
                                 complement=tk.terms[1])
    assert torch.equal(again, got)


def test_complement_derivation(data):
    """_complement_kernel against the JAX package's: the rest of a sum (also
    nested), and the same refusals."""
    jk, tk = _kernels()
    tau = np.linspace(0, 3, 7)
    for i in (0, 1):
        got = tgp._complement_kernel(tk, tk.terms[i])
        want = jgp._complement_kernel(jk, jk.terms[i])
        assert got is tk.terms[1 - i]
        assert_rel_close(got.get_value(t64(tau)), np.asarray(want.get_value(tau)), 1e-14)
    assert tgp._complement_kernel(tk, tk) is None

    inner = ct.RealTerm(a=0.2, c=2.0)
    nested = tk + (inner + ct.RealTerm(a=0.1, c=0.3))
    rest = tgp._complement_kernel(nested, inner)
    assert_rel_close(rest.get_value(t64(tau)),
                     (nested.get_value(t64(tau)) - inner.get_value(t64(tau))).numpy(),
                     1e-14)
    assert [type(x).__name__ for x in tgp._flat_terms(nested)] == [
        "SHOTerm", "RealTerm", "RealTerm", "RealTerm"]

    stranger = ct.RealTerm(a=0.1, c=2.0)
    for full, part, match in ((tk, stranger, "uniquely"),
                              (tk.terms[0], stranger, "complement"),
                              (ct.TermSum(tk.terms[0]), tk.terms[0], "IS the full")):
        with pytest.raises(ValueError, match=match):
            tgp._complement_kernel(full, part)
    for full, part in ((jk, jt.RealTerm(a=0.1, c=2.0)),
                       (jk.terms[0], jt.RealTerm(a=0.1, c=2.0))):
        with pytest.raises(ValueError):
            jgp._complement_kernel(full, part)

    # the sampler itself refuses a component it cannot complement
    t, _, y = data
    gp = ct.GaussianProcess(tk, t, yerr=0.2)
    cond = gp.condition(y, t=np.linspace(0, 10, 5), kernel=stranger)
    with pytest.raises(ValueError, match="uniquely"):
        cond.sample_pathwise(torch.Generator().manual_seed(0))
    cond = ct.GaussianProcess(tk.terms[0], t, yerr=0.2).condition(
        y, t=np.linspace(0, 10, 5), kernel=stranger)
    with pytest.raises(ValueError, match="complement"):
        cond.sample_pathwise(torch.Generator().manual_seed(0))


# ============================================================== the fleet

C = 3
THETAS = np.array([[1.0, 3.0, 2.0], [1.4, 4.5, 2.8], [0.8, 2.2, 1.5]])


def _fleet_kernel(mod, theta):
    """An SHOTerm of theta plus a fixed RealTerm in either package."""
    return (mod.SHOTerm(sigma=theta[..., 0], rho=theta[..., 1], tau=theta[..., 2])
            + mod.RealTerm(a=0.3, c=0.7))


def _fleet(data, own_times):
    """The fleet's state (one gp_compute over C thetas), its chains'
    one-system states, and the times of each chain."""
    t, yerr, _ = data
    if own_times:
        shift = np.arange(C)[:, None] * 0.37
        tc = np.sort(t[None, :] + shift * np.sin(t)[None, :] * 0.1, axis=-1)
    else:
        tc = np.broadcast_to(t, (C, N))
    tt = t64(tc) if own_times else t64(t)
    mean = t64([0.1, -0.2, 0.3])
    state = ct.gp_compute(_fleet_kernel(ct, t64(THETAS)), tt, yerr=yerr, mean=mean)
    singles = [ct.gp_compute(_fleet_kernel(ct, t64(THETAS[i])), t64(tc[i]),
                             yerr=yerr, mean=float(mean[i])) for i in range(C)]
    return state, singles, tc, mean.numpy()


def _jax_states(data, tc, means):
    t, yerr, _ = data

    def compute(theta, ti, m):
        return jgp.gp_compute(_fleet_kernel(jt, theta), ti, yerr=yerr, mean=m)

    with jax_config(backend="scan"):
        return jax.jit(jax.vmap(compute))(jnp.asarray(THETAS), jnp.asarray(tc),
                                          jnp.asarray(means))


FLEET_CALLS = ["gp_sample_conditional", "gp_log_likelihood", "gp_apply_inverse",
               "gp_dot_tril", "gp_sample"]


@pytest.mark.parametrize("own_times", [False, True], ids=["shared_t", "own_t"])
@pytest.mark.parametrize("call", FLEET_CALLS)
def test_fleet_against_chains_and_jax_vmap(data, call, own_times):
    """One call over a chain-axis state equals each chain's one-system call
    (1e-12) and the JAX package's jax.vmap over its stack of states on the
    same noises (1e-10)."""
    t, _, y = data
    state, singles, tc, means = _fleet(data, own_times)
    assert state.d.shape == (C, N) and state.W.shape == (C, N, 2 + 1)
    assert state.c.shape == (C, 3) and state.ok.shape == (C,) and bool(state.ok.all())
    rng = np.random.default_rng(12)
    t_new = np.linspace(-0.5, 10.5, M)
    ys = y[None, :] + 0.1 * rng.normal(size=(C, N))
    S = 4
    z = rng.normal(size=(C, S, N + M))
    eps = rng.normal(size=(C, S, N))
    Y = rng.normal(size=(C, N, 2))

    def ours(st, i=None):
        """The port's call on the fleet (i None) or on chain i's state."""
        pick = (lambda x: x) if i is None else (lambda x: x[i])
        if call == "gp_sample_conditional":
            mean = t64(means) if i is None else float(means[i])
            kernel = _fleet_kernel(ct, t64(THETAS) if i is None else t64(THETAS[i]))
            g = torch.Generator().manual_seed(5)
            drawn = ct.gp_sample_conditional(st, kernel, pick(t64(ys)), t_new, g,
                                             shape=(S,), mean=mean)
            noise = tgp._pathwise_core(st, kernel, pick(t64(ys)), t64(t_new),
                                       pick(t64(z)), pick(t64(eps)))
            return drawn, noise + (t64(means)[:, None, None] if i is None
                                   else float(means[i]))
        if call == "gp_log_likelihood":
            return getattr(ct, call)(st, pick(t64(ys))), None
        if call == "gp_apply_inverse":
            return getattr(ct, call)(st, pick(t64(Y))), getattr(ct, call)(st, pick(t64(ys)))
        if call == "gp_dot_tril":
            return getattr(ct, call)(st, pick(t64(Y))), None
        g = torch.Generator().manual_seed(5)
        return ct.gp_sample(st, g, shape=(S,)), None

    fleet, fleet_noise = ours(state)
    for i, single in enumerate(singles):
        one, one_noise = ours(single, i)
        if call in ("gp_sample_conditional", "gp_sample"):
            # one generator draws the fleet's normals at once: the fleet's
            # shape, each chain's their own
            assert fleet.shape == (C, S, M if call != "gp_sample" else N)
            assert one.shape == fleet.shape[1:]
        else:
            assert_rel_close(fleet[i], one, 1e-12, f"chain {i}")
        if fleet_noise is not None:
            assert_rel_close(fleet_noise[i], one_noise, 1e-12, f"chain {i}")

    if call == "gp_sample":
        # the fleet's draw is L sqrt(d) z + mean of the generator's normals
        g = torch.Generator().manual_seed(5)
        zz = torch.randn(C, S, N, generator=g, dtype=torch.float64)
        want = ct.gp_dot_tril(state, zz.mT).mT + state.mean_value[:, None, :]
        assert torch.equal(fleet, want)
        return
    if call == "gp_sample_conditional":
        g = torch.Generator().manual_seed(5)
        zz = torch.randn(C, S, N + M, generator=g, dtype=torch.float64)
        ee = torch.randn(C, S, N, generator=g, dtype=torch.float64)
        kernel = _fleet_kernel(ct, t64(THETAS))
        want = tgp._pathwise_core(state, kernel, t64(ys), t64(t_new), zz, ee)
        assert torch.equal(fleet, want + t64(means)[:, None, None])

    jstates = _jax_states(data, tc, means)
    with jax_config(backend="scan"):
        if call == "gp_sample_conditional":
            def one(st, theta, yi, zi, ei, m):
                return jgp._pathwise_core(st, _fleet_kernel(jt, theta), yi,
                                          jnp.asarray(t_new), zi, ei) + m

            want = jax.jit(jax.vmap(one))(jstates, jnp.asarray(THETAS), jnp.asarray(ys),
                                 jnp.asarray(z), jnp.asarray(eps), jnp.asarray(means))
            assert_rel_close(fleet_noise, np.asarray(want), RTOL)
        elif call == "gp_log_likelihood":
            want = jax.jit(jax.vmap(jgp.gp_log_likelihood))(jstates, jnp.asarray(ys))
            assert_rel_close(fleet, np.asarray(want), RTOL)
        else:
            fn = jax.jit(jax.vmap(getattr(jgp, call)))
            want = fn(jstates, jnp.asarray(Y))
            assert_rel_close(fleet, np.asarray(want), RTOL)
            if call == "gp_apply_inverse":
                want = fn(jstates, jnp.asarray(ys))
                assert_rel_close(fleet_noise, np.asarray(want), RTOL)


def test_fleet_shapes_and_refusals(data):
    """A shared y broadcasts over the fleet; the shell and the dense
    conditional moments stay one system."""
    t, yerr, y = data
    state, singles, _, _ = _fleet(data, False)
    ll = ct.gp_log_likelihood(state, y)
    assert ll.shape == (C,)
    for i in range(C):
        np.testing.assert_allclose(
            ll[i].item(), ct.gp_log_likelihood(singles[i], y).item(), rtol=1e-12)
    assert ct.gp_apply_inverse(state, y).shape == (C, N)
    assert ct.gp_sample(state, torch.Generator().manual_seed(0)).shape == (C, N)
    draws = ct.gp_sample_conditional(state, _fleet_kernel(ct, t64(THETAS)), y,
                                     np.linspace(0, 10, 7),
                                     torch.Generator().manual_seed(0), shape=(2, 3))
    assert draws.shape == (C, 2, 3, 7) and torch.isfinite(draws).all()
    with pytest.raises(ValueError, match="one system"):
        ct.GaussianProcess(_fleet_kernel(ct, t64(THETAS)), t, yerr=yerr)
    gp = ct.GaussianProcess(_fleet_kernel(ct, t64(THETAS[0])), t, yerr=yerr)
    cond = gp.condition(y, t=np.linspace(0, 10, 7))
    gp._state = state
    for what in ("variance", "covariance"):
        with pytest.raises(ValueError, match="one system"):
            getattr(cond, what)
    with pytest.raises(ValueError, match="at most one chain axis"):
        ct.gp_compute(_fleet_kernel(ct, t64(THETAS)[None]), t, yerr=yerr)

