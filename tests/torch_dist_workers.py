"""Rank workers of the sharded-path and group tests (imported by
tests/test_torch_sharded.py, tests/test_torch_groups.py and the ranks they
spawn; not a test module).

Imports only PyTorch, numpy and the port, so that a spawned rank never runs
tests/conftest.py's JAX set-up.  Each rank joins a gloo group through a
``file://`` rendezvous, runs one check function of this module on CPU
tensors in float64, and saves what it computed for the test process, which
holds it against the JAX package.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

import celerite2_torch as ct
from celerite2_torch.inference import run_hmc, run_nuts, run_smc
from celerite2_torch.inference.checkpoint import CheckpointManager
from celerite2_torch.parallel import comm, make_mesh, seq_sharding
from celerite2_torch.parallel import sharded as sh
from celerite2_torch.parallel.train_step import make_hmc_train_step

ct.set_config(device="cpu")
# build the adjoint's dense step maps a few rows at a time, as at full size
sh.PAIR_CHUNK = 1 << 12


# ------------------------------------------------------------------ kernels


def sho(theta, mod=ct):
    """J = 2: SHOTerm(sigma, rho, tau) of ``theta[..., :3]``."""
    return mod.SHOTerm(sigma=theta[..., 0], rho=theta[..., 1], tau=theta[..., 2])


def mixture(theta, mod=ct):
    """J = 4: the SHO above and an overdamped SHOTerm (Q = 0.3) of
    ``theta[..., 3:5]``."""
    return sho(theta, mod) + mod.SHOTerm(sigma=theta[..., 3], rho=theta[..., 4], Q=0.3)


def wide(theta, mod=ct):
    """J = 8: the mixture and two more SHOTerms scaled from it."""
    return (mixture(theta, mod)
            + mod.SHOTerm(sigma=0.5 * theta[..., 0], rho=2.3 * theta[..., 1], Q=0.5)
            + mod.SHOTerm(sigma=0.4 * theta[..., 3], rho=3.1 * theta[..., 4], Q=1.2))


def exp_sho(theta):
    """The SHOTerm of log-parameters (make_hmc_train_step's builder)."""
    e = theta.exp()
    return ct.SHOTerm(sigma=e[..., 0], rho=e[..., 1], tau=e[..., 2])


BUILDERS = {"sho": sho, "mixture": mixture, "wide": wide}
THETAS = {"sho": [1.2, 4.0, 3.0], "mixture": [1.2, 4.0, 3.0, 0.7, 1.5],
          "wide": [1.2, 4.0, 3.0, 0.7, 1.5]}


# ------------------------------------------------------------------ spawning


def spawn(world, target, payload, tmpdir):
    """Run ``target`` (a function of this module) on ``world`` spawned ranks
    with ``payload``; returns each rank's result.  A rank that fails raises
    here."""
    tmpdir = str(tmpdir)
    payload_file = os.path.join(tmpdir, f"{target}.{world}.payload")
    torch.save(payload, payload_file)
    init = f"file://{os.path.join(tmpdir, f'{target}.{world}.rdv')}"
    torch.multiprocessing.spawn(_rank, args=(world, init, target, payload_file),
                                nprocs=world, join=True)
    return [torch.load(f"{payload_file}.{r}", weights_only=False) for r in range(world)]


def _rank(rank, world, init, target, payload_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = globals()[target](torch.load(payload_file, weights_only=False))
        torch.save(out, f"{payload_file}.{rank}")
    finally:
        dist.destroy_process_group()


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def gathered(x, group, dim=1):
    """This rank's rows of ``x`` put back together along ``dim`` (every
    rank's, in order)."""
    return torch.cat(comm.all_gather(x.contiguous(), group).unbind(0), dim)


# ------------------------------------------------------------------ checks


def sharded_checks(p):
    """Everything of ``parallel.sharded`` on a (1, world) mesh, for each case
    of ``p["cases"]``: the log-likelihood's value and theta-gradient (one
    chain and a chain axis of two), its t-gradient, the ops, the
    predictions and the pathwise sampler; and the quiet -inf."""
    mesh = make_mesh(chains=1, seq=dist.get_world_size())
    group = mesh.seq_group
    out = {}
    for name, case in p["cases"].items():
        build = BUILDERS[case["builder"]]
        t, y, yerr = (np.asarray(case[k]) for k in ("t", "y", "yerr"))
        N = t.shape[0]
        sl = seq_sharding(mesh, N)
        res = {}
        # value and theta-gradient, one chain, then two
        logd = sh.make_sharded_logdensity(build, t, y, yerr, mesh)
        theta = t64(THETAS[case["builder"]]).requires_grad_(True)
        ll = logd(theta)
        (g,) = torch.autograd.grad(ll, theta)
        res["ll"], res["grad"] = ll.item(), g.numpy()
        thetas = t64(case["thetas"]).requires_grad_(True)
        lls = logd(thetas)
        (gs,) = torch.autograd.grad(lls.sum(), thetas)
        res["lls"], res["grads"] = lls.detach().numpy(), gs.numpy()

        # the t-gradient at fixed celerite matrices
        c, a, U, V = (t64(x) for x in case["matrices"])
        c, a, U, V = c[None], a[None, sl], U[None, sl], V[None, sl]
        t_l = t64(t[sl]).requires_grad_(True)
        ll_t = sh.sharded_loglik(t_l, c, a, U, V, t64(y[sl]), group=group)
        (bt,) = torch.autograd.grad(ll_t.sum(), t_l)
        res["ll_fixed"] = ll_t.item()
        res["bt"] = gathered(bt[None], group)[0].numpy()

        # the ops on this rank's rows, put back together
        tl, yl = t64(t[sl]), t64(y[sl])[None]
        d, W, ok = sh.sharded_factor(tl, c, a, U, V, group=group)
        res["ok"] = bool(ok.item())
        ops = {
            "d": d, "W": W,
            "solve_lower": sh.sharded_solve_lower(tl, c, U, W, yl, group=group),
            "solve_upper": sh.sharded_solve_upper(tl, c, U, W, yl, group=group),
            "matmul_lower": sh.sharded_matmul_lower(tl, c, U, V, yl, group=group),
            "matmul_upper": sh.sharded_matmul_upper(tl, c, U, V, yl, group=group),
            "apply_inverse": sh.sharded_apply_inverse(tl, c, U, W, d, yl, group=group),
            "dot_tril": sh.sharded_dot_tril(tl, c, U, W, d, yl, group=group),
            "predict_mean": sh.sharded_predict_mean(
                tl, c, a, U, V, t64(yerr[sl] ** 2), yl, group=group),
        }
        Y3 = t64(case["Y"][sl])[None]
        ops["solve_lower_K"] = sh.sharded_solve_lower(tl, c, U, W, Y3, group=group)
        ops["matmul_upper_K"] = sh.sharded_matmul_upper(tl, c, U, V, Y3, group=group)
        for k, v in ops.items():
            res[k] = gathered(v, group)[0].numpy()

        # the predictions at new points (replicated)
        t_new = t64(case["t_new"])
        _, _, U2, V2 = (x[None] for x in build(t64(THETAS[case["builder"]]))
                        .get_celerite_matrices(t_new, torch.zeros_like(t_new)))
        res["predict_mean_at"] = sh.sharded_predict_mean_at(
            tl, c, a, U, V, yl, t_new, U2, V2, group=group)[0].numpy()
        KxsT = t64(case["KxsT"][sl])
        res["variance"] = sh.sharded_conditional_variance(
            tl, c, a, U, V, KxsT, case["k0"], group=group)[0].numpy()
        res["covariance"] = sh.sharded_conditional_covariance(
            tl, c, a, U, V, KxsT, t64(case["Kss"]), group=group)[0].numpy()

        # the pathwise sampler, draws of the generator's normals
        kernel = build(t64(THETAS[case["builder"]]))
        for reg in (None, 1e-7):
            sample = sh.make_sharded_conditional_sampler(
                kernel, t, y, yerr, case["t_new"], mesh, mean=0.3, regularize=reg)
            res[f"pathwise_{reg}"] = sample(torch.Generator().manual_seed(5),
                                            shape=(3,)).numpy()
        out[name] = res

    # the quiet -inf: a RealTerm of negative amplitude, no noise
    case = p["nonpd"]
    logd = sh.make_sharded_logdensity(
        lambda th: ct.RealTerm(a=th[..., 0], c=th[..., 1]), case["t"],
        case["y"], case["yerr"], mesh)
    theta = t64([-5.0, 0.5]).requires_grad_(True)
    ll = logd(theta)
    (g,) = torch.autograd.grad(ll, theta)
    out["nonpd"] = {"ll": ll.item(), "grad": g.numpy()}
    return out


def train_checks(p):
    """``make_hmc_train_step`` on a (2, world / 2) mesh fed the given draws,
    and ``run_hmc`` with its chains over all ranks; each rank returns its
    chains' results and where they sit."""
    world = dist.get_world_size()
    mesh = make_mesh(chains=2, seq=world // 2)
    t, y, yerr = (np.asarray(p[k]) for k in ("t", "y", "yerr"))
    step_fn, init_fn = make_hmc_train_step(exp_sho, t, y, yerr, mesh,
                                           step_size=0.01, num_leapfrog=2)
    C = p["qs"].shape[0]
    mine = slice(mesh.chain_index * C // 2, (mesh.chain_index + 1) * C // 2)
    qs = t64(p["qs"])[mine]
    q1, acc = step_fn(qs, draws=(t64(p["z"]), t64(p["u"])))
    q2, acc2 = step_fn(q1, torch.Generator().manual_seed(9))
    init = init_fn(C, 3, torch.Generator().manual_seed(4))
    out = {"chains": mine, "q1": q1.numpy(), "accept": acc.numpy(),
           "q2": q2.numpy(), "accept2": acc2.numpy(), "init": init.numpy()}

    # run_hmc over every rank's chains, each rank's log-density on one device
    tt, yy = t64(t), t64(y)

    def logpost(q):
        ll = ct.gp_loglik(exp_sho(q), tt, yy, yerr=float(yerr[0]))
        return ll - 0.5 * ((q / 3.0) ** 2).sum(-1)

    res = run_hmc(logpost, t64([0.0, 1.5, 1.0]), torch.Generator().manual_seed(1),
                  num_warmup=6, num_samples=4, num_chains=p["hmc_chains"],
                  max_leapfrog=6, chain_group=dist.group.WORLD)
    out["hmc"] = {k: getattr(res, k).numpy() for k in res._fields}
    out["hmc_chains"] = slice(dist.get_rank() * p["hmc_chains"] // world,
                              (dist.get_rank() + 1) * p["hmc_chains"] // world)
    out["resumed"] = resume_check(p, logpost, world)
    return out


class _Stop(Exception):
    """Ends a run after a chunk, as a killed job would."""


def resume_check(p, logpost, world):
    """``run_hmc`` with its chains over every rank, in chunks of 4 steps with
    checkpoints under one shared manager: stopped after its second chunk,
    rank 0's newest checkpoint removed (a rank that lagged the others), then
    resumed.  Also whether ``on_retry`` is refused with a group."""
    manager = CheckpointManager(os.path.join(p["ckpt"], f"hmc{world}"))

    def run(**kw):
        return run_hmc(logpost, t64([0.0, 1.5, 1.0]), torch.Generator().manual_seed(1),
                       num_warmup=6, num_samples=4, num_chains=p["hmc_chains"],
                       max_leapfrog=6, chain_group=dist.group.WORLD, chunk_size=4,
                       checkpoint=manager, **kw)

    def stop_after_second(step, stats):
        if step == 8:
            raise _Stop

    try:
        run(monitor=stop_after_second)
    except _Stop:
        pass
    if dist.get_rank() == 0:
        os.remove(os.path.join(manager.directory, "rank_0", "step_1.pt"))
    dist.barrier()
    res = run()
    try:
        run(on_retry=lambda *a: None)
        refused = False
    except ValueError:
        refused = True
    return {"hmc": {k: getattr(res, k).numpy() for k in res._fields},
            "retry_refused": refused}


def dryrun_check(p):
    """``parallel.dryrun.dryrun_multichip`` on the CPU ranks."""
    from celerite2_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(device=torch.device("cpu"))


# ------------------------------------------------------------ the groups


def gaussian_logp(q):
    """test_chain_sharded_nuts's Gaussian, batched: mean [1, -1, 0],
    precision diag(1, 2, 0.5)."""
    r = q - torch.tensor([1.0, -1.0, 0.0], dtype=q.dtype)
    return -0.5 * (r * torch.tensor([1.0, 2.0, 0.5], dtype=q.dtype) * r).sum(-1)


GAUSSIAN_RUN = dict(num_warmup=300, num_samples=300, num_chains=8)


def gp_logpost(p):
    """The log-posterior of ``exp_sho``'s parameters on the payload's data
    (the run_hmc checks' posterior)."""
    tt, yy = t64(p["t"]), t64(p["y"])

    def logpost(q):
        ll = ct.gp_loglik(exp_sho(q), tt, yy, yerr=float(p["yerr"][0]))
        return ll - 0.5 * ((q / 3.0) ** 2).sum(-1)

    return logpost


# chunks of 4 transitions, a dense metric: the resume's run
GP_NUTS_RUN = dict(num_warmup=6, num_samples=4, num_chains=8, max_depth=5,
                   dense_mass=True, chunk_size=4)
GP_NUTS_INIT = [0.0, 1.5, 1.0]


def smc_toy():
    """test_particle_sharded_smc's toy: (log_prior, log_like, sample_prior)
    batched, the prior N(0, 9 I) and the likelihood's mean [0.5, -0.25]."""
    mu = torch.tensor([0.5, -0.25], dtype=torch.float64)

    def log_prior(q):
        return -0.5 * (q**2).sum(-1) / 9.0

    def log_like(q):
        return -0.5 * ((q - mu) ** 2).sum(-1) / 0.25

    def sample_prior(gen, n):
        return 3.0 * torch.randn((n, 2), generator=gen, dtype=torch.float64)

    return log_prior, log_like, sample_prior


SMC_RUN = dict(num_particles=512, mutation_steps=8, mutation_eps=0.4)
# the evidence's runs: one run's estimate spreads by 0.10 at 512 particles
# (measured over 20 seeds), so the closed form is held on their mean
EVIDENCE_SEEDS = range(16)


def fields(res):
    return {k: getattr(res, k).numpy() for k in res._fields}


def group_checks(p):
    """``run_nuts(..., chain_group=)`` and ``run_smc(..., particle_group=)``
    over every rank: the Gaussian NUTS run, the GP NUTS run with a dense
    metric in chunks (stopped after its second chunk with rank 0 a
    checkpoint behind, then resumed), the SMC toy; whether ``on_retry``,
    chains and particles that do not divide are refused."""
    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    out = {"rank": rank, "world": world}
    res = run_nuts(gaussian_logp, torch.zeros(3, dtype=torch.float64),
                   torch.Generator().manual_seed(0), chain_group=group, **GAUSSIAN_RUN)
    out["gaussian"] = fields(res)

    logpost = gp_logpost(p)
    manager = CheckpointManager(os.path.join(p["ckpt"], f"nuts{world}"))

    def run(**kw):
        return run_nuts(logpost, t64(GP_NUTS_INIT), torch.Generator().manual_seed(3),
                        chain_group=group, checkpoint=manager, **GP_NUTS_RUN, **kw)

    def stop_after_second(step, stats):
        if step == 8:
            raise _Stop

    try:
        run(monitor=stop_after_second)
    except _Stop:
        pass
    out["saved"] = sorted(os.listdir(os.path.join(manager.directory, f"rank_{rank}")))
    if rank == 0:
        os.remove(os.path.join(manager.directory, "rank_0", "step_1.pt"))
    dist.barrier()
    out["gp_resumed"] = fields(run())

    refused = {}
    for name, call in (
            ("on_retry", lambda: run_nuts(gaussian_logp, torch.zeros(3, dtype=torch.float64),
                                          torch.Generator().manual_seed(0), chain_group=group,
                                          num_warmup=2, num_samples=2, num_chains=8,
                                          on_retry=lambda *a: None)),
            ("chains", lambda: run_nuts(gaussian_logp, torch.zeros(3, dtype=torch.float64),
                                        torch.Generator().manual_seed(0), chain_group=group,
                                        num_warmup=2, num_samples=2,
                                        num_chains=2 * world + 1)),
            ("particles", lambda: run_smc(*smc_toy(), torch.Generator().manual_seed(3),
                                          num_particles=2 * world + 1,
                                          particle_group=group))):
        try:
            call()
            refused[name] = False
        except ValueError:
            refused[name] = True
    out["refused"] = refused

    out["smc"] = fields(run_smc(*smc_toy(), torch.Generator().manual_seed(3),
                                particle_group=group, **SMC_RUN))
    out["evidence"] = [float(run_smc(*smc_toy(), torch.Generator().manual_seed(s),
                                     particle_group=group, **SMC_RUN).log_evidence)
                       for s in EVIDENCE_SEEDS]
    return out
