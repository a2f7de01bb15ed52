"""The port's NUTS (celerite2_torch.inference: nuts, sampler) against the
JAX package's, float64 on the CPU.

The port's fleet transition runs on JAX's own draws (``jax_draws`` turns
the split and ``fold_in`` keys of ``nuts_kernel`` into the port's
``NUTSDraws``) beside JAX's ``nuts_kernel`` vmapped over the same chains:
1e-12 on a Gaussian and 1e-9 on the tutorial GP posterior, with a diagonal
and a dense metric, and chains that U-turn at once, diverge and reach the
maximum depth; the integer and boolean fields are equal, and the port
evaluates the log-density as often as the vmapped loops run.  Then the
step-size search, a run of the adaptation across slow-window ends, the
statistics of ``run_nuts`` and its bitwise resume from a checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celerite2_torch.inference import (
    CheckpointManager,
    build_nuts_step,
    run_nuts,
    summary,
    warmup_and_sample,
)
from celerite2_torch.inference import adapt as tadapt
from celerite2_torch.inference import nuts as tnuts
from celerite2_torch.inference import sampler as tsampler
from celerite2_torch.utils.observe import sampling_monitor
from celerite2_tpu.inference import nuts as jnuts
from celerite2_tpu.inference import sampler as jsampler
from test_torch_hmc import gaussian, tutorial_posterior
from torch_parity import assert_rel_close

# ------------------------------------------------------------ JAX's draws


def _one_draw(key, dim, D):
    """What ``nuts_kernel`` draws from ``key``: the momentum's normals, the
    directions, and the uniforms of each leaf and of each doubling."""
    key_mom, key_dirs, key_tree = jax.random.split(key, 3)
    z = jax.random.normal(key_mom, (dim,), jnp.float64)
    dirs = jax.random.rademacher(key_dirs, (D,), dtype=jnp.int32)
    leaf_keys = jax.random.split(key_tree, D + 1)

    def uniform(k, i):
        return jax.random.uniform(jax.random.fold_in(k, i), dtype=jnp.float64)

    u_leaf = jnp.concatenate([
        jax.vmap(lambda i, k=leaf_keys[d]: uniform(k, i))(jnp.arange(2**d))
        for d in range(D)])
    u_tree = jax.vmap(lambda d: uniform(leaf_keys[D], d))(jnp.arange(D))
    return z, dirs, u_leaf, u_tree


_draws = jax.jit(jax.vmap(_one_draw, in_axes=(0, None, None)), static_argnums=(1, 2))


def jax_draws(keys, dim, D):
    """The port's draws of one transition from the chains' JAX keys."""
    return tnuts.NUTSDraws(*(torch.tensor(np.asarray(x)) for x in _draws(keys, dim, D)))


def leaves_per_doubling(num_steps, D):
    """(C, D): the leaves each chain took in each doubling, from its total
    (the doublings fill in order, and the one a chain stops in holds the
    rest)."""
    n = np.asarray(num_steps)[:, None]
    first = 2 ** np.arange(D) - 1
    return np.clip(n - first, 0, 2 ** np.arange(D))


def vmapped_evaluations(num_steps, D):
    """The log-density evaluations of JAX's vmapped transition: one at the
    start, then per doubling the largest number of leaves any chain
    takes."""
    return 1 + int(leaves_per_doubling(num_steps, D).max(0).sum())


# ---------------------------------------------------------------- targets

_TARGETS = {}


def target(name):
    """(JAX log-density, the port's batched one, the chains' start, their
    step sizes, D, rtol), built once per module."""
    if name not in _TARGETS:
        if name == "gaussian":
            jax_logp, logp, _, _ = gaussian()
            q0 = np.random.default_rng(0).normal(size=(5, 3))
            # max depth; two trajectories that turn; one that turns at once;
            # one whose every step diverges
            eps = np.asarray([0.01, 0.5, 1.5, 4.0, 300.0])
            _TARGETS[name] = (jax_logp, logp, q0, eps, 6, 1e-12)
        else:
            jax_logp, logp = tutorial_posterior()
            rng = np.random.default_rng(5)
            init = np.asarray([0.0, 0.0, 0.0, np.log(10.0), 0.0, np.log(5.0),
                               np.log(0.01)])
            q0 = init + 0.1 * rng.normal(size=(5, 7))
            eps = np.asarray([0.001, 0.05, 0.2, 2.0, 30.0])
            _TARGETS[name] = (jax_logp, logp, q0, eps, 4, 1e-9)
    return _TARGETS[name]


def metric(dense, C, dim, seed=2):
    """Per-chain metrics: diagonal (C, dim) or dense SPD (C, dim, dim)."""
    rng = np.random.default_rng(seed)
    if not dense:
        return rng.uniform(0.5, 1.5, (C, dim))
    A = rng.normal(size=(C, dim, dim)) * 0.3
    return A @ A.transpose(0, 2, 1) + np.eye(dim)


_JAX_KERNELS = {}


def jax_kernel(name, D):
    if name not in _JAX_KERNELS:
        jax_logp = target(name)[0]
        _JAX_KERNELS[name] = jax.jit(jax.vmap(
            lambda q, k, e, m: jnuts.nuts_kernel(jax_logp, q, k, e, m, max_depth=D)))
    return _JAX_KERNELS[name]


# ------------------------------------------------- transitions against JAX


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
@pytest.mark.parametrize("name", ["gaussian", "tutorial"])
def test_transition_against_jax(name, dense):
    _, logp, q0, eps, D, rtol = target(name)
    C, dim = q0.shape
    m = metric(dense, C, dim)
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    jq, jlogp, jinfo = jax_kernel(name, D)(jnp.asarray(q0), keys, jnp.asarray(eps),
                                           jnp.asarray(m))
    counts = {}
    tq, tlogp, tinfo, tg = tnuts.nuts_kernel(
        logp, torch.tensor(q0), jax_draws(keys, dim, D), torch.tensor(eps),
        torch.tensor(m), max_depth=D, counts=counts)

    for field in ("num_steps", "diverging", "turning"):
        np.testing.assert_array_equal(getattr(tinfo, field).numpy(),
                                      np.asarray(getattr(jinfo, field)), field)
    assert tinfo.num_steps.dtype == torch.int32
    for label, got, want in (("q", tq, jq), ("logp", tlogp, jlogp),
                             ("accept_prob", tinfo.accept_prob, jinfo.accept_prob),
                             ("energy", tinfo.energy, jinfo.energy)):
        assert_rel_close(got.numpy(), np.asarray(want), rtol, label)
    # the gradient handed on is the potential's at the new state
    _, g_want = tnuts._potential_and_grad(logp, tq)
    assert_rel_close(tg.numpy(), g_want.numpy(), rtol, "g")

    # the fleet's evaluations are what the vmapped loops run, and the host
    # reads at most once per leapfrog step and once per doubling
    assert counts["evaluations"] == vmapped_evaluations(jinfo.num_steps, D)
    assert counts["host_reads"] <= counts["evaluations"] - 1 + counts["doublings"]

    steps = tinfo.num_steps.numpy()
    div, turn = tinfo.diverging.numpy(), tinfo.turning.numpy()
    assert steps[0] == 2**D - 1 and not turn[0]  # to the maximum depth
    assert div[4] and not div[:3].any()  # a large step diverges
    if name == "gaussian":
        assert steps[3] == 1 and turn[3] and not div[3]  # a U-turn at once


def test_stopped_chains_keep_their_state_bitwise():
    """A fleet where one chain stops early: the chains that run on do not
    change the stopped chain's result, which is that of its run alone."""
    _, logp, q0, eps, D, _ = target("gaussian")
    C, dim = q0.shape
    m = torch.tensor(metric(False, C, dim))
    draws = jax_draws(jax.random.split(jax.random.PRNGKey(1), C), dim, D)
    fleet = tnuts.nuts_kernel(logp, torch.tensor(q0), draws, torch.tensor(eps), m,
                              max_depth=D)
    for c in (3, 4):
        alone = tnuts.nuts_kernel(
            logp, torch.tensor(q0[c:c + 1]), tnuts.NUTSDraws(*(x[c:c + 1] for x in draws)),
            torch.tensor(eps[c:c + 1]), m[c:c + 1], max_depth=D)
        assert torch.equal(fleet[0][c], alone[0][0])
        assert torch.equal(fleet[1][c], alone[1][0])
        for f, a in zip(fleet[2], alone[2]):
            assert torch.equal(f[c], a[0])


def test_nan_positions_stay_quiet():
    """A chain whose log-density is -inf with a zero gradient past a wall
    (the non-PD contract of gp_loglik) diverges, and its state stays
    finite."""
    _, logp, _, _ = gaussian()

    def walled(q):
        lp = logp(q)
        return torch.where(q[:, 0] > 2.0, torch.full_like(lp, -torch.inf), lp)

    q0 = torch.tensor([[1.9, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    draws = tnuts.draw_nuts(torch.Generator().manual_seed(3), 2, 3, 5)
    draws = draws._replace(z=torch.tensor([[3.0, 0.0, 0.0], [0.1, 0.2, 0.3]]),
                           directions=torch.ones(2, 5, dtype=torch.float64))
    q, logp_new, info, g = tnuts.nuts_kernel(
        walled, q0, draws, 0.5, torch.ones(2, 3, dtype=torch.float64), max_depth=5)
    assert bool(info.diverging[0])
    assert torch.isfinite(q).all() and torch.isfinite(logp_new).all()
    assert torch.isfinite(g).all()


def test_build_nuts_step():
    _, logp, q0, eps, D, _ = target("gaussian")
    C, dim = q0.shape
    draws = jax_draws(jax.random.split(jax.random.PRNGKey(1), C), dim, D)
    m = torch.tensor(metric(False, C, dim))
    step = build_nuts_step(logp, max_depth=D)
    got = step(torch.tensor(q0), draws, torch.tensor(eps), m)
    want = tnuts.nuts_kernel(logp, torch.tensor(q0), draws, torch.tensor(eps), m,
                             max_depth=D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2].num_steps,
                                                        want[2].num_steps)


@pytest.mark.parametrize("x", [1, 2, 3, 4, 6, 8, 12, 64, 96, 1024, 2**20 - 2**19])
def test_ctz_exact(x):
    assert tnuts._ctz(x) == int(jnuts._ctz(jnp.int32(x)))


# ---------------------------------------------------------- the adaptation


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_step_size_against_jax(dense):
    """_find_reasonable_step_size per chain on the same momentum; the
    chains start where eps doubles and where it halves."""
    jax_logp, logp, _, _ = gaussian()
    q0 = np.asarray([[1.0, -2.0, 0.5], [30.0, 20.0, -10.0], [0.0, 0.0, 0.0],
                     [1e3, 0.0, 0.0]])
    C, dim = q0.shape
    m = metric(dense, C, dim)
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    want = jax.jit(jax.vmap(lambda q, k, mm: jsampler._find_reasonable_step_size(
        jax_logp, q, k, mm)))(jnp.asarray(q0), keys, jnp.asarray(m))
    z = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(keys)
    got = tsampler._find_reasonable_step_size(
        logp, torch.tensor(q0), torch.tensor(np.asarray(z)), torch.tensor(m))
    assert_rel_close(got.numpy(), np.asarray(want), 1e-12, "eps")
    assert len(set(np.log2(got.numpy()).round().tolist())) > 1


def run_chains_draws(keys, dim, D, total):
    """JAX _run_chains's draws: the step-size search's normals, then each
    transition's, from the chains' keys."""
    keys, keys_eps = jax.vmap(jax.random.split, out_axes=1)(keys)
    z_eps = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(keys_eps)
    draws = []
    for _ in range(total):
        keys, k = jax.vmap(jax.random.split, out_axes=1)(keys)
        draws.append(jax_draws(k, dim, D))
    return torch.tensor(np.asarray(z_eps)), draws


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_run_chains_against_jax(dense):
    """_run_chains over 20 warmup transitions (a fast window, slow windows
    with three ends, the freeze) and 6 draws, against JAX's on the same
    keys' draws."""
    jax_logp, logp, _, _ = gaussian()
    W, S, D, C, dim = 20, 6, 5, 3, 3
    q0 = np.random.default_rng(8).normal(size=(C, dim))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    want = jsampler._run_chains(jax_logp, jnp.asarray(q0), keys, num_warmup=W,
                                num_samples=S, max_depth=D, dense_mass=dense)
    sched = tsampler._schedule(W, S, 1)
    assert sched[2].sum() >= 2 and sched[3][W - 1]
    z_eps, draws = run_chains_draws(keys, dim, D, W + S)
    carry = tsampler._init_carry(logp, torch.tensor(q0), z_eps, torch.Generator(),
                                 dense_mass=dense)
    carry, outs = tsampler._nuts_segment(logp, carry, sched, draws, max_depth=D,
                                         target_accept=0.8)
    samples, logps, accs, steps, divs = (x[W:].transpose(0, 1).numpy() for x in outs)
    np.testing.assert_array_equal(steps, np.asarray(want[3]))
    np.testing.assert_array_equal(divs, np.asarray(want[4]))
    for label, got, w in (("samples", samples, want[0]), ("log_prob", logps, want[1]),
                          ("accept_prob", accs, want[2]),
                          ("step_size", carry.eps_frozen.numpy(), want[5]),
                          ("inv_mass", carry.inv_mass.numpy(), want[6])):
        assert_rel_close(got, np.asarray(w), 1e-9, label)


def test_mass_helpers_per_chain():
    """The chain axis of the metric helpers and the Welford state: each
    chain's row is bitwise its single-chain result."""
    rng = np.random.default_rng(6)
    C, dim = 4, 3
    p = torch.tensor(rng.normal(size=(C, dim)))
    for dense in (False, True):
        m = torch.tensor(metric(dense, C, dim))
        mv, kin, mom = (tadapt.mass_matvec(m, p), tadapt.mass_kinetic(m, p),
                        tadapt.mass_momentum(p, m))
        assert kin.shape == (C,)
        for c in range(C):
            assert_rel_close(mv[c].numpy(), tadapt.mass_matvec(m[c], p[c]).numpy(),
                             1e-15, "matvec")
            assert_rel_close(kin[c].numpy(), tadapt.mass_kinetic(m[c], p[c]).numpy(),
                             1e-15, "kinetic")
            assert_rel_close(mom[c].numpy(), tadapt.mass_momentum(p[c], m[c]).numpy(),
                             1e-15, "momentum")
        xs = torch.tensor(rng.normal(size=(7, C, dim)))
        wf = tadapt.welford_init(dim, dense=dense, chains=C)
        singles = [tadapt.welford_init(dim, dense=dense) for _ in range(C)]
        for x in xs:
            wf = tadapt.welford_update(wf, x)
            singles = [tadapt.welford_update(s, x[c]) for c, s in enumerate(singles)]
        var = tadapt.welford_variance(wf)
        for c, s in enumerate(singles):
            assert torch.equal(wf.mean[c], s.mean) and torch.equal(wf.m2[c], s.m2)
            assert torch.equal(var[c], tadapt.welford_variance(s))


# --------------------------------------------------------------- run_nuts


def correlated_gaussian():
    mu = np.asarray([1.0, -0.5])
    cov = np.asarray([[1.0, 0.9], [0.9, 2.0]])
    prec, mu_t = torch.tensor(np.linalg.inv(cov)), torch.tensor(mu)

    def logp(q):
        r = q - mu_t
        return -0.5 * ((r @ prec) * r).sum(-1)

    return logp, mu, cov


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_run_nuts_moments(dense):
    """run_nuts on a correlated 2-d Gaussian: means and variances within 4
    Monte Carlo standard errors; with ``dense_mass`` the chains' metric is
    the covariance, within 4 standard errors of the last slow window's
    estimate."""
    logp, mu, cov = correlated_gaussian()
    W, S, C = 300, 500, 4
    res = run_nuts(logp, torch.zeros(2, dtype=torch.float64),
                   torch.Generator().manual_seed(0), num_warmup=W, num_samples=S,
                   num_chains=C, max_depth=6, dense_mass=dense)
    s = summary(res.samples)
    ess = s["ess"].numpy()
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(s["mean"].numpy() - mu) < 4 * sd / np.sqrt(ess))
    var = s["sd"].numpy() ** 2
    assert np.all(np.abs(var - np.diag(cov)) < 4 * np.diag(cov) * np.sqrt(2 / ess))
    assert np.all(s["rhat"].numpy() < 1.05)
    assert float(res.diverging.double().mean()) < 0.01
    assert res.step_size.shape == (C,) and res.num_steps.shape == (C, S)
    if dense:
        assert res.inv_mass.shape == (C, 2, 2)
        n = C * np.diff(np.flatnonzero(tadapt.build_schedule(W)[1]))[-1]
        se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov**2) / n)
        assert np.all(np.abs(res.inv_mass.mean(0).numpy() - cov) < 4 * se + 0.05 * cov)
    else:
        assert res.inv_mass.shape == (C, 2)


def test_warmup_and_sample_single_chain():
    logp, _, _ = correlated_gaussian()
    res = warmup_and_sample(logp, np.zeros(2), torch.Generator().manual_seed(1),
                            num_warmup=20, num_samples=10, max_depth=4)
    assert res.samples.shape == (10, 2) and res.step_size.shape == ()
    assert res.samples.device.type == "cpu"


RUN = dict(num_warmup=30, num_samples=20, num_chains=3, max_depth=5, chunk_size=20)


def test_run_nuts_resumes_bitwise(tmp_path):
    """A chunked run stopped after its first chunk and resumed from the
    checkpoint gives exactly the results of the run without the stop, and
    its chunks feed the monitor."""
    logp, _, _ = correlated_gaussian()
    init = torch.zeros(2, dtype=torch.float64)
    with sampling_monitor(log_every=0) as (emit, records):
        ref = run_nuts(logp, init, torch.Generator().manual_seed(0), **RUN,
                       monitor=emit)
    assert [s for s, _ in records] == [20, 40, 50]
    assert all(0.0 <= r["mean_accept"] <= 1.0 for _, r in records)

    class Killed(Exception):
        pass

    def dying_monitor(step, stats):
        raise Killed

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    with pytest.raises(Killed):
        run_nuts(logp, init, torch.Generator().manual_seed(0), **RUN,
                 checkpoint=mgr, monitor=dying_monitor)
    assert mgr.latest_step() == 0
    # a fresh generator: the checkpoint's state is what the resumed run draws from
    res = run_nuts(logp, init, torch.Generator().manual_seed(123), **RUN,
                   checkpoint=CheckpointManager(str(tmp_path / "ck"), max_to_keep=5))
    for name in res._fields:
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
