"""The sharded paths of celerite2_torch (``celerite2_torch.parallel``) on gloo
groups of 2 and 4 CPU ranks, held against the JAX package's unsharded
functions in float64.

The ranks are spawned once a group size per module (``tests/torch_dist_workers.py``
holds what they run: the port only) and save their results; the tests hold
those against the JAX package at ``tests/test_sharding.py``'s tolerances for
the same comparisons.  The JAX side runs its unsharded functions; its
``shard_map`` versions stay in the slow tier (tests/test_sharding.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
import torch_dist_workers as W
from celerite2_tpu import GaussianProcess as JaxGP
from celerite2_tpu import ops as jops
from celerite2_tpu import terms as jt
from celerite2_tpu.gp import gp_compute, gp_log_likelihood
from celerite2_tpu.parallel import make_mesh as jax_make_mesh
from celerite2_tpu.parallel.train_step import make_hmc_train_step as jax_train_step
from celerite2_torch.inference import run_hmc
from celerite2_torch.parallel import make_sharded_logdensity
from celerite2_torch.parallel.train_step import make_hmc_train_step

WORLDS = (2, 4)
CASES = {"J2": ("sho", 128), "J4": ("mixture", 128), "J8": ("wide", 64)}
M_NEW = 11  # N + M does not divide over the ranks: the union is padded


def _data(n, seed=99):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 20, n))
    yerr = rng.uniform(0.1, 0.3, n)
    y = np.sin(0.8 * t) + yerr * rng.normal(size=n)
    return t, yerr, y


def _case(builder, n):
    t, yerr, y = _data(n)
    theta = np.asarray(W.THETAS[builder])
    kernel = W.BUILDERS[builder](jnp.asarray(theta), jt)
    # targets before, inside and after the training span (none repeats a
    # training time: the joint prior would be singular, ROADMAP C8)
    t_new = np.sort(np.concatenate([np.linspace(-2.0, 22.0, M_NEW - 1), [0.0]]))
    c, a, U, V = (np.asarray(x) for x in kernel.get_celerite_matrices(t, yerr**2))
    rng = np.random.default_rng(n)
    return {
        "builder": builder, "t": t, "y": y, "yerr": yerr, "t_new": t_new,
        "thetas": np.stack([theta, theta * np.linspace(0.8, 1.2, theta.size)]),
        "matrices": (c, a, U, V), "Y": rng.normal(size=(n, 3)),
        "KxsT": np.asarray(kernel.get_value(t[:, None] - t_new[None, :])),
        "k0": float(np.asarray(kernel.get_value(np.zeros(1)))[0]),
        "Kss": np.asarray(kernel.get_value(t_new[:, None] - t_new[None, :])),
    }


def _train_payload():
    t, yerr, y = _data(64)
    qs = 0.1 * np.random.default_rng(3).normal(size=(8, 3))
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    split = jax.vmap(jax.random.split)(keys)
    z = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float64))(split[:, 0]))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(split[:, 1]))
    return {"t": t, "y": y, "yerr": yerr, "qs": qs, "keys": np.asarray(keys), "z": z,
            "u": u, "hmc_chains": 8}


@pytest.fixture(scope="module")
def payload():
    cases = {name: _case(*spec) for name, spec in CASES.items()}
    t, yerr, y = _data(128)
    nonpd = {"t": t, "y": 0.0 * y, "yerr": 0.0 * yerr}
    return {"cases": cases, "nonpd": nonpd}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    """The ranks' results: ``{world: [rank 0's, rank 1's, ...]}``."""
    tmp = tmp_path_factory.mktemp("sharded")
    return {w: W.spawn(w, "sharded_checks", payload, tmp) for w in WORLDS}


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    p = dict(_train_payload(), ckpt=str(tmp))
    return p, {w: W.spawn(w, "train_checks", p, tmp) for w in WORLDS}


def _jax_kernel(case, theta=None):
    theta = W.THETAS[case["builder"]] if theta is None else theta
    return W.BUILDERS[case["builder"]](jnp.asarray(theta), jt)


def _jax_ll(case, theta):
    state = gp_compute(_jax_kernel(case, theta), case["t"], yerr=case["yerr"])
    return gp_log_likelihood(state, case["y"])


# The JAX references, each computed once for both group sizes (jitted: the
# JAX package's functions run op by op are many times slower)


@functools.lru_cache(maxsize=None)
def _value_and_grads(name):
    case = _case(*CASES[name])
    fn = jax.jit(jax.value_and_grad(lambda th: _jax_ll(case, th)))
    thetas = [W.THETAS[case["builder"]], *case["thetas"]]
    return [tuple(map(np.asarray, fn(jnp.asarray(th)))) for th in thetas]


@functools.lru_cache(maxsize=None)
def _conditional(name):
    case = _case(*CASES[name])
    gp = JaxGP(_jax_kernel(case), t=case["t"], yerr=case["yerr"])
    cond = gp.condition(case["y"], t=case["t_new"])
    return {"mu": np.asarray(gp.predict(case["y"], t=case["t_new"], include_mean=False)),
            "variance": np.asarray(cond.variance),
            "covariance": np.asarray(cond.covariance)}


# ------------------------------------------------------ the log-likelihood


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loglik_value_and_theta_grad(payload, ranks, world, name):
    v_ref, g_ref = _value_and_grads(name)[0]
    for res in ranks[world]:  # replicated on every rank
        got = res[name]
        np.testing.assert_allclose(got["ll"], float(v_ref), rtol=1e-9)
        np.testing.assert_allclose(got["grad"], np.asarray(g_ref), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["J2", "J4"])
def test_sharded_loglik_chain_axis(payload, ranks, world, name):
    got = ranks[world][0][name]
    for k, (v_ref, g_ref) in enumerate(_value_and_grads(name)[1:]):
        np.testing.assert_allclose(got["lls"][k], float(v_ref), rtol=1e-9)
        np.testing.assert_allclose(got["grads"][k], np.asarray(g_ref), rtol=1e-7,
                                   atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loglik_time_gradient(payload, ranks, world, name):
    case = payload["cases"][name]
    c, a, U, V = (jnp.asarray(x) for x in case["matrices"])
    y = jnp.asarray(case["y"])

    def ll(tj):
        d, _, z = jops.factor_solve(tj, c, a, U, V, y[:, None])
        safe = jnp.where(d > 0, d, 1.0)
        return -0.5 * (jnp.sum(jnp.log(safe)) + jnp.sum(z[:, 0] ** 2 / safe)
                       + tj.shape[0] * np.log(2 * np.pi))

    tj = jnp.asarray(case["t"])
    value, grad = jax.jit(jax.value_and_grad(ll))(tj)
    got = ranks[world][0][name]
    np.testing.assert_allclose(got["ll_fixed"], float(value), rtol=1e-9)
    np.testing.assert_allclose(got["bt"], np.asarray(grad), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_nonpd_minus_inf(ranks, world):
    for res in ranks[world]:
        assert np.isneginf(res["nonpd"]["ll"])
        np.testing.assert_array_equal(res["nonpd"]["grad"], 0.0)


def test_sharded_loglik_is_hand_adjoint():
    from celerite2_torch.parallel.sharded import ShardedLoglik

    assert issubclass(ShardedLoglik, torch.autograd.Function)


# ------------------------------------------------------------------ the ops


@functools.lru_cache(maxsize=None)
def _ops_reference(name):
    case = _case(*CASES[name])
    c, a, U, V = (jnp.asarray(x) for x in case["matrices"])
    t, y = jnp.asarray(case["t"]), jnp.asarray(case["y"])
    Y3 = jnp.asarray(case["Y"])
    d, Wm = jops.factor(t, c, a, U, V)
    lo = jops.solve_lower(t, c, U, Wm, y[:, None])[:, 0]
    z0 = jnp.sqrt(d) * y
    gp = JaxGP(_jax_kernel(case), t=case["t"], yerr=case["yerr"])
    return {
        "d": d, "W": Wm, "solve_lower": lo,
        "solve_upper": jops.solve_upper(t, c, U, Wm, y[:, None])[:, 0],
        "matmul_lower": jops.matmul_lower(t, c, U, V, y[:, None])[:, 0],
        "matmul_upper": jops.matmul_upper(t, c, U, V, y[:, None])[:, 0],
        "apply_inverse": jops.solve_upper(t, c, U, Wm, (lo / d)[:, None])[:, 0],
        "dot_tril": z0 + jops.matmul_lower(t, c, U, Wm, z0[:, None])[:, 0],
        "predict_mean": gp.predict(y),
        "solve_lower_K": jops.solve_lower(t, c, U, Wm, Y3),
        "matmul_upper_K": jops.matmul_upper(t, c, U, V, Y3),
    }


# tests/test_sharding.py's tolerances: the factor's d at 1e-9, the rest at
# 1e-8 with atol 1e-10 (the predicted mean at atol 1e-9)
OPS_TOL = {"d": (1e-9, 0.0), "predict_mean": (1e-8, 1e-9)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ops_match_unsharded(payload, ranks, world, name):
    case = payload["cases"][name]
    got = ranks[world][0][name]
    assert got["ok"]
    for op, want in _ops_reference(name).items():
        rtol, atol = OPS_TOL.get(op, (1e-8, 1e-10))
        np.testing.assert_allclose(got[op], np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=op)
    for res in ranks[world][1:]:  # every rank put the same rows together
        np.testing.assert_array_equal(res[name]["d"], got["d"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_predictions_match_conditional(payload, ranks, world, name):
    want = _conditional(name)
    for res in ranks[world]:
        got = res[name]
        np.testing.assert_allclose(got["predict_mean_at"], want["mu"], rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(got["variance"], want["variance"], rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(got["covariance"], want["covariance"], rtol=1e-6,
                                   atol=1e-8)


@functools.lru_cache(maxsize=None)
def _pathwise(name, regularize):
    case = _case(*CASES[name])
    N, M = case["t"].shape[0], M_NEW
    gen = torch.Generator().manual_seed(5)
    z = torch.randn((3, N + M), generator=gen, dtype=torch.float64).numpy()
    eps = torch.randn((3, N), generator=gen, dtype=torch.float64).numpy()
    gp = JaxGP(_jax_kernel(case), t=case["t"], yerr=case["yerr"], mean=0.3)
    cond = gp.condition(case["y"], t=case["t_new"])
    transform = jax.jit(lambda z, e: cond._pathwise_transform(z, e, regularize=regularize))
    return np.asarray(transform(jnp.asarray(z), jnp.asarray(eps)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("regularize", [None, 1e-7])
def test_sharded_pathwise_matches_jax(ranks, world, name, regularize):
    want = _pathwise(name, regularize)
    for res in ranks[world]:
        np.testing.assert_allclose(res[name][f"pathwise_{regularize}"], want,
                                   rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------- the train step


@pytest.mark.parametrize("world", WORLDS)
def test_hmc_train_step_matches_jax(train_ranks, world):
    p, results = train_ranks
    q_ref, acc_ref = _jax_step()
    for res in results[world]:
        sl = res["chains"]
        np.testing.assert_allclose(res["q1"], q_ref[sl], rtol=1e-9)
        np.testing.assert_array_equal(res["accept"], acc_ref[sl])


@functools.lru_cache(maxsize=None)
def _jax_step():
    p = _train_payload()
    def builder(th):
        e = jnp.exp(th)
        return jt.SHOTerm(sigma=e[0], rho=e[1], tau=e[2])

    step, _ = jax_train_step(builder, p["t"], p["y"], p["yerr"],
                             jax_make_mesh(chains=1, seq=1), step_size=0.01,
                             num_leapfrog=2)
    q_ref, acc_ref = step(jnp.asarray(p["qs"]), jnp.asarray(p["keys"]))
    return np.asarray(q_ref), np.asarray(acc_ref)


def _stiff8(theta, mod):
    """J = 8: four SHOTerms, three near critical damping (Q = 0.3, 0.4, 0.5),
    whose paired reverse flow has step maps of norms near 1e6 on data 0.5
    apart."""
    e = jnp.exp(theta) if mod is jt else theta.exp()
    k = mod.SHOTerm(sigma=e[0], rho=e[1], tau=e[2])
    for j in range(3):
        k = k + mod.SHOTerm(sigma=e[0] * (0.5 + 0.2 * j), rho=e[1] * (1.7 + j),
                            Q=0.3 + 0.1 * j)
    return k


def test_sharded_loglik_gradient_keeps_its_digits_at_a_stiff_j8_term():
    """The one-rank CPU route at D = 81 walks the rows, as the card's kernel
    does; a doubling of the stiff step maps lost 1.7e-6 of the gradient
    here (2.3e-4 at N = 2000)."""
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 250.0, 500))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=t.size)
    yerr = np.full(t.size, 0.25)
    theta = np.log([1.0, 5.0, 3.0])
    g_ref = jax.grad(lambda th: gp_log_likelihood(
        gp_compute(_stiff8(th, jt), t, yerr=yerr), y))(jnp.asarray(theta))
    logd = make_sharded_logdensity(functools.partial(_stiff8, mod=ct), t, y, yerr, None,
                                   device="cpu")
    th = torch.tensor(theta, requires_grad=True)
    (g,) = torch.autograd.grad(logd(th), th)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_hmc_train_step_draws_do_not_depend_on_the_layout(train_ranks, world):
    p, results = train_ranks
    step, init = make_hmc_train_step(W.exp_sho, p["t"], p["y"], p["yerr"], None,
                                     step_size=0.01, num_leapfrog=2, device="cpu")
    q1, _ = step(torch.tensor(p["qs"]), draws=(torch.tensor(p["z"]),
                                               torch.tensor(p["u"])))
    q2, acc2 = step(q1, torch.Generator().manual_seed(9))
    q0 = init(8, 3, torch.Generator().manual_seed(4))
    for res in results[world]:
        sl = res["chains"]
        np.testing.assert_allclose(res["q2"], q2.numpy()[sl], rtol=1e-9)
        np.testing.assert_array_equal(res["accept2"], acc2.numpy()[sl])
        np.testing.assert_array_equal(res["init"], q0.numpy()[sl])


@pytest.mark.parametrize("world", WORLDS)
def test_run_hmc_chain_group_matches_one_process(train_ranks, world):
    p, results = train_ranks
    tt, yy = torch.as_tensor(p["t"]), torch.as_tensor(p["y"])

    def logpost(q):
        ll = ct.gp_loglik(W.exp_sho(q), tt, yy, yerr=float(p["yerr"][0]))
        return ll - 0.5 * ((q / 3.0) ** 2).sum(-1)

    ref = run_hmc(logpost, torch.tensor([0.0, 1.5, 1.0], dtype=torch.float64),
                  torch.Generator().manual_seed(1), num_warmup=6, num_samples=4,
                  num_chains=p["hmc_chains"], max_leapfrog=6)
    for res in results[world]:
        sl = res["hmc_chains"]
        for field, want in ref._asdict().items():
            want = want.numpy()
            if field in ("samples", "log_prob", "accept_prob", "diverging"):
                want = want[sl]
            np.testing.assert_allclose(res["hmc"][field], want, rtol=1e-9, atol=1e-12,
                                       err_msg=field)


@pytest.mark.parametrize("world", WORLDS)
def test_run_hmc_chain_group_resumes_from_checkpoints(train_ranks, world):
    """A chunked run over the ranks, stopped after its second chunk with one
    rank a checkpoint behind, resumes where every rank can (its first
    chunk) and ends as the one-process chunked run does; with the group a
    retry hook is refused."""
    p, results = train_ranks
    tt, yy = torch.as_tensor(p["t"]), torch.as_tensor(p["y"])

    def logpost(q):
        ll = ct.gp_loglik(W.exp_sho(q), tt, yy, yerr=float(p["yerr"][0]))
        return ll - 0.5 * ((q / 3.0) ** 2).sum(-1)

    ref = run_hmc(logpost, torch.tensor([0.0, 1.5, 1.0], dtype=torch.float64),
                  torch.Generator().manual_seed(1), num_warmup=6, num_samples=4,
                  num_chains=p["hmc_chains"], max_leapfrog=6, chunk_size=4)
    for res in results[world]:
        sl = res["hmc_chains"]
        assert res["resumed"]["retry_refused"]
        for field, want in ref._asdict().items():
            want = want.numpy()
            if field in ("samples", "log_prob", "accept_prob", "diverging"):
                want = want[sl]
            np.testing.assert_allclose(res["resumed"]["hmc"][field], want, rtol=1e-9,
                                       atol=1e-12, err_msg=field)


def test_dryrun_multichip(tmp_path):
    (res, *_) = W.spawn(4, "dryrun_check", {}, tmp_path)
    assert res == {"mesh": (1, 4), "step": (2, 3), "hmc": (2, 4, 3), "draw": (7,)}
