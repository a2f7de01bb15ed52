"""The port's fleet sampler (celerite2_torch.inference: hmc, chunked,
checkpoint) against the JAX package's, float64 on the CPU.

``_hmc_segment`` runs on JAX's own draws (the normals and uniforms that
``jax.random.split(carry.key, 3)`` gives each iteration) from the same
carry (``carry_from_numpy``): 1e-12 on a Gaussian target, 1e-9 on the
tutorial GP posterior with one chain whose proposals diverge; the step
counts, divergences and accept decisions agree exactly.  ``run_hmc``
recovers a Gaussian's moments, and a chunked run resumed from a
checkpoint is bitwise equal to the run without the stop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.inference import CheckpointManager, run_hmc, summary
from celerite2_torch.inference import hmc as thmc
from celerite2_torch.inference.chunked import drive_chunks
from celerite2_torch.utils.observe import sampling_monitor
from celerite2_tpu import terms as jt
from celerite2_tpu.gp import gp_loglik as jax_gp_loglik
from celerite2_tpu.inference import adapt as jadapt
from celerite2_tpu.inference import hmc as jhmc
from torch_parity import assert_rel_close

# ------------------------------------------------------------- targets


def gaussian(dim=3, seed=11):
    """tests/test_hmc.py's Gaussian target in both packages: (JAX scalar
    log-density, the port's batched one, mean, covariance)."""
    rng = np.random.default_rng(seed)
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


def tutorial_data():
    """The reference quickstart's data process (benchmarks/configs.py
    ``tutorial_data``: seed 42, two uniform windows, N = 125)."""
    np.random.seed(42)
    t = np.sort(np.append(np.random.uniform(0, 3.8, 57),
                          np.random.uniform(5.5, 10, 68)))
    yerr = np.random.uniform(0.08, 0.22, len(t))
    y = (0.2 * (t - 5) + np.sin(3 * t + 0.1 * (t - 5) ** 2)
         + yerr * np.random.randn(len(t)))
    return t, yerr, y


def tutorial_posterior(prior_sigma=2.0):
    """benchmarks/configs.py ``tutorial_logpost`` (params = [mean,
    log_sigma1, log_rho1, log_tau, log_sigma2, log_rho2, log_jitter]) in
    both packages: (JAX scalar log-density, the port's batched one)."""
    t, yerr, y = tutorial_data()

    def jax_logpost(params):
        th = jnp.exp(params[1:])
        kernel = (jt.SHOTerm(sigma=th[0], rho=th[1], tau=th[2])
                  + jt.SHOTerm(sigma=th[3], rho=th[4], Q=0.25))
        ll = jax_gp_loglik(kernel, jnp.asarray(t), jnp.asarray(y) - params[0],
                           diag=jnp.asarray(yerr) ** 2 + th[5])
        return ll - 0.5 * jnp.sum((params / prior_sigma) ** 2)

    tt, yerr_t, yt = (torch.tensor(x) for x in (t, yerr, y))

    def logpost(params):
        th = params[:, 1:].exp()
        kernel = (ct.SHOTerm(sigma=th[:, 0], rho=th[:, 1], tau=th[:, 2])
                  + ct.SHOTerm(sigma=th[:, 3], rho=th[:, 4], Q=0.25))
        ll = ct.gp_loglik(kernel, tt, yt - params[:, :1],
                          diag=yerr_t**2 + th[:, 5:])
        return ll - 0.5 * ((params / prior_sigma) ** 2).sum(-1)

    return jax_logpost, logpost


# ------------------------------------------------- segment against JAX


def schedule(num_warmup, num_samples):
    """run_hmc's schedule: (is_warm, in_slow, win_end, freeze, u)."""
    total = num_warmup + num_samples
    in_slow, win_end = jadapt.build_schedule(num_warmup)
    pad = np.zeros(num_samples, bool)
    return (
        np.concatenate([np.ones(num_warmup, bool), pad]),
        np.concatenate([in_slow, pad]),
        np.concatenate([win_end, pad]),
        np.eye(1, total, num_warmup - 1, dtype=bool)[0],
        jhmc._halton(total),
    )


def jax_carry(jax_logp, q0, eps0, log_T0, key):
    """A JAX carry at q0 (as run_hmc builds it, with log T = log_T0)."""
    q0 = jnp.asarray(q0)
    pot, g = jax.vmap(jax.value_and_grad(lambda x: -jax_logp(x)))(q0)
    eps0 = jnp.asarray(eps0)
    dim = q0.shape[1]
    return jhmc._HMCCarry(
        q=q0, logp=-pot, g=g, da=jadapt.da_init(eps0),
        adam=jhmc._adam_init(q0.dtype), log_T=jnp.asarray(log_T0),
        wf=jadapt.welford_init(dim, q0.dtype), inv_mass=jnp.ones((dim,)),
        eps_frozen=eps0, key=key,
    )


def jax_draws(key, S, C, dim):
    """The normals and uniforms the JAX segment draws in S iterations."""
    zs, us = [], []
    for _ in range(S):
        key, k_mom, k_acc = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(k_mom, (C, dim), jnp.float64)))
        us.append(np.asarray(jax.random.uniform(k_acc, (C,), jnp.float64)))
    return np.stack(zs), np.stack(us)


def carry_fields(carry):
    return {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in carry._asdict().items() if k != "key"}


def check_segment(jax_logp, logp, q0, sched, *, eps0, log_T0, max_leapfrog,
                  rtol, seed=0):
    """Both segments from the same carry on JAX's draws; returns the
    port's outputs."""
    key = jax.random.PRNGKey(seed)
    carry = jax_carry(jax_logp, q0, eps0, log_T0, key)
    seg = jax.jit(lambda c, s: jhmc._hmc_segment(
        jax_logp, c, s, max_leapfrog=max_leapfrog, target_accept=0.8))
    jcarry, jouts = seg(carry, tuple(jnp.asarray(s) for s in sched))
    S, (C, dim) = len(sched[0]), q0.shape
    z, u = jax_draws(key, S, C, dim)

    tcarry = thmc.carry_from_numpy(carry_fields(carry), generator=torch.Generator())
    tcarry, touts = thmc._hmc_segment(
        logp, tcarry, sched, (torch.tensor(z), torch.tensor(u)),
        max_leapfrog=max_leapfrog, target_accept=0.8)

    jq, jlogp, jacc, jsteps, jdiv = (np.asarray(x) for x in jouts)
    tq, tlogp, tacc, tsteps, tdiv = (x.numpy() for x in touts)
    np.testing.assert_array_equal(tsteps, jsteps)
    np.testing.assert_array_equal(tdiv, jdiv)
    np.testing.assert_array_equal(u < tacc, u < jacc)
    for name, got, want in (("q", tq, jq), ("logp", tlogp, jlogp),
                            ("accept_prob", tacc, jacc)):
        assert_rel_close(got, want, rtol, name)
    want = carry_fields(jcarry)
    got = {k: jax.tree_util.tree_map(lambda x: x.numpy(), v)
           for k, v in tcarry._asdict().items() if k != "rng"}
    for name in want:
        for i, (g, w) in enumerate(zip(jax.tree_util.tree_leaves(got[name]),
                                       jax.tree_util.tree_leaves(want[name]))):
            assert_rel_close(g, w, rtol, f"{name}[{i}]")
    return touts


def test_segment_gaussian_against_jax():
    """C = 8, S = 12: the warmup's fast and slow windows, two window ends,
    the freeze, then sampling."""
    jax_logp, logp, _, _ = gaussian()
    rng = np.random.default_rng(3)
    q0 = rng.normal(size=(8, 3))
    sched = schedule(8, 4)
    assert sched[2].sum() == 2 and sched[3][7]
    outs = check_segment(jax_logp, logp, q0, sched, eps0=0.4,
                         log_T0=np.log(1.6), max_leapfrog=16, rtol=1e-12)
    assert outs[3].max() > 1  # trajectories of several steps


def test_segment_tutorial_gp_against_jax():
    """The tutorial posterior (J = 4, N = 125), C = 4, S = 6: three chains
    near the mode and one far in the tail (a mean of 5 with both
    amplitudes and the jitter near zero, where the data's misfit gives
    gradients of thousands), whose every proposal diverges."""
    jax_logp, logp = tutorial_posterior()
    rng = np.random.default_rng(5)
    init = np.asarray([0.0, 0.0, 0.0, np.log(10.0), 0.0, np.log(5.0), np.log(0.01)])
    q0 = init + 0.1 * rng.normal(size=(4, 7))
    q0[3] = init + np.asarray([5.0, -3.0, 0.0, 0.0, -3.0, 0.0, -5.0])
    sched = schedule(4, 2)
    outs = check_segment(jax_logp, logp, q0, sched, eps0=0.05,
                         log_T0=np.log(0.2), max_leapfrog=8, rtol=1e-9)
    div = outs[4].numpy()
    assert div[:, 3].all() and not div[:, :3].all()


# ----------------------------------------------------------- run_hmc


def test_run_hmc_gaussian():
    """tests/test_hmc.py's recovery of a Gaussian's moments."""
    _, logp, mu, cov = gaussian()
    res = run_hmc(logp, torch.zeros(3, dtype=torch.float64),
                  torch.Generator().manual_seed(0), num_warmup=500,
                  num_samples=500, num_chains=16, max_leapfrog=128)
    s = summary(res.samples)
    np.testing.assert_allclose(s["mean"].numpy(), mu, atol=0.3)
    np.testing.assert_allclose(s["sd"].numpy(), np.sqrt(np.diag(cov)), rtol=0.25)
    assert np.all(s["rhat"].numpy() < 1.05)
    assert np.all(s["ess"].numpy() > 400)
    assert float(res.diverging.double().mean()) < 0.01
    # ChEES should have grown the trajectory past a single step
    assert float(res.trajectory_length) > float(res.step_size)


def test_run_hmc_shared_adaptation_outputs():
    """Step size, trajectory and mass are shared across the fleet."""
    _, logp, _, _ = gaussian()
    res = run_hmc(logp, torch.zeros(3, dtype=torch.float64),
                  torch.Generator().manual_seed(5), num_warmup=100,
                  num_samples=50, num_chains=4, max_leapfrog=32)
    assert res.step_size.shape == ()
    assert res.trajectory_length.shape == ()
    assert res.inv_mass.shape == (3,)
    assert res.samples.shape == (4, 50, 3)
    assert res.num_steps.shape == (50,)
    assert res.num_steps.min() >= 1 and res.num_steps.max() <= 32


def test_run_hmc_places_numbers_on_the_default_device():
    """A numpy start goes to Config.device (the CPU in these tests)."""
    _, logp, _, _ = gaussian()
    res = run_hmc(logp, np.zeros(3), torch.Generator().manual_seed(1),
                  num_warmup=4, num_samples=2, num_chains=2, max_leapfrog=4)
    assert res.samples.device.type == "cpu"
    assert res.samples.dtype == torch.float64


# ------------------------------------------- chunks, checkpoints, retries

RUN = dict(num_warmup=30, num_samples=30, num_chains=4, max_leapfrog=16,
           chunk_size=20)


def test_chunked_run_monitor_stats():
    """run_hmc's chunks emit their stats through sampling_monitor."""
    _, logp, _, _ = gaussian()
    with sampling_monitor(log_every=0) as (emit, records):
        res = run_hmc(logp, torch.zeros(3, dtype=torch.float64),
                      torch.Generator().manual_seed(0), **RUN, monitor=emit)
    assert [s for s, _ in records] == [20, 40, 60]
    for _, stats in records:
        assert 0.0 <= stats["mean_accept"] <= 1.0
        assert stats["step_size"] > 0
    assert torch.isfinite(res.samples).all()


def test_chunked_run_resumes_bitwise(tmp_path):
    """A chunked run stopped after its first chunk and resumed from the
    checkpoint gives exactly the samples of the run without the stop; a
    resume under another chunk_size raises."""
    _, logp, _, _ = gaussian()
    init = torch.zeros(3, dtype=torch.float64)
    ref = run_hmc(logp, init, torch.Generator().manual_seed(0), **RUN)

    class Killed(Exception):
        pass

    def dying_monitor(step, stats):
        raise Killed

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    with pytest.raises(Killed):
        run_hmc(logp, init, torch.Generator().manual_seed(0), **RUN,
                checkpoint=mgr, monitor=dying_monitor)
    assert mgr.latest_step() == 0

    # a fresh generator: the checkpoint's state is what the resumed run draws from
    res = run_hmc(logp, init, torch.Generator().manual_seed(123), **RUN,
                  checkpoint=CheckpointManager(str(tmp_path / "ck"), max_to_keep=5))
    for name in ("samples", "log_prob", "accept_prob", "num_steps", "diverging",
                 "step_size", "trajectory_length", "inv_mass"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name

    with pytest.raises(ValueError, match="chunk"):
        run_hmc(logp, init, torch.Generator().manual_seed(0),
                **dict(RUN, chunk_size=25),
                checkpoint=CheckpointManager(str(tmp_path / "ck")))


def test_checkpoint_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert torch.equal(mgr.restore()["x"], torch.full((2,), 3.0))
    assert torch.equal(mgr.restore(2)["x"], torch.full((2,), 2.0))


def test_drive_chunks_retries_after_a_fault():
    """tests/test_fit_checkpoint.py's retry test through the port's
    drive_chunks: a chunk whose run raises is retried from the host copy
    of the carry and the run ends with the fault-free results; with the
    retries spent, the error surfaces."""
    calls = {"n": 0, "fail_at": -1}

    def seg_fn(carry, sched):
        (steps,) = sched
        outs = carry + torch.cumsum(torch.as_tensor(steps), 0)
        calls["n"] += 1
        if calls["n"] == calls["fail_at"]:
            raise RuntimeError("injected device fault")
        return outs[-1], outs

    sched = (np.arange(1.0, 13.0, dtype=np.float32),)
    carry0 = torch.zeros(())
    ref_carry, ref_outs = drive_chunks(seg_fn, carry0, sched, chunk_size=4)

    calls.update(n=0, fail_at=3)
    retries = []
    carry, outs = drive_chunks(seg_fn, carry0, sched, chunk_size=4, max_retries=2,
                               on_retry=lambda i, k, e: retries.append((i, k)))
    assert retries == [(2, 1)]
    assert torch.equal(carry, ref_carry) and torch.equal(outs, ref_outs)

    calls.update(n=0, fail_at=2)
    with pytest.raises(RuntimeError, match="injected device fault"):
        drive_chunks(seg_fn, carry0, sched, chunk_size=4, max_retries=0)
