"""Reads how many digits the pathwise sampler's joint prior keeps at
bench.py's size as its jitter grows, on one NVIDIA GPU and its host's CPU.

The joint prior of ``sample_pathwise`` (the kernel over the sorted union of
the training times and the targets) has no observational diagonal; its
jitter is ``regularize``.  For ``chip_smoke.py``'s two quick-start models
(``PATHWISE_MODELS``: config5's J = 4 mixture and ``wide8`` at J = 8) on
``gp_data``'s N = 1e5 times and M = 1e4 targets, float64, and each jitter
in ``JITTERS``, it reads:

- the joint prior's smallest pivot over its variance (the CPU route);
- its draw ``L sqrt(d) Z`` (two columns of normals) against the factor's
  and the lower product's row recursions in numpy's long double: on the
  CPU's plain route, and on the card on the scan tier (``factor_fwd``,
  ``sweep_fwd``) and the assoc tier (``riccati_prefix``,
  ``mat_affine_prefix``);
- ``sample_pathwise`` on the card on each tier against the CPU route on the
  same normals (a CPU generator), as ``chip_smoke.py``'s phase "pathwise"
  holds them.

The CPU's readings run in worker processes, one a (model, jitter), beside
the card's.

    python3 pathwise_jitter.py

writes one JSON object a (model, jitter) to
``chiprun_out/pathwise_jitter.jsonl`` and prints each.

    python3 pathwise_jitter.py --law N M

runs on the CPU alone, at a size small enough for the law's Jacobian: on
bench.py's density of times (N over N / 100 units) with M evenly spaced
targets, as ``gp_data`` places them, it prints for each model and jitter the
smallest pivot, the prior draw against long double, and how far ``A A^T``
lies from the conditional covariance, A the Jacobian of
``_pathwise_transform`` in its normals, read as the affine map's columns
at unit normals (relative to the covariance's largest entry): whether the draws keep their law where the map from the
normals loses digits, and what the jitter does to the law.
"""

import argparse
import json
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from celerite2_torch import gp as tgp

OUT = Path(__file__).resolve().parent / "chiprun_out" / "pathwise_jitter.jsonl"
JITTERS = {"J=4": (None, 1e-9, 1e-8, 1e-7),
           "J=8": (None, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)}
TIERS = ("scan", "assoc")
Z_SEED = 5


def longdouble_prior_draw(t, c, a, U, V, Z):
    """L sqrt(d) Z by the factor's and the lower product's row recursions
    in numpy's long double, rounded to float64 (one system; None where long
    double is no wider than float64)."""
    ld = np.longdouble
    if np.finfo(ld).eps >= np.finfo(np.float64).eps:
        return None
    t, c, a, U, V, Z = (x.cpu().numpy().astype(ld) for x in (t, c, a, U, V, Z))
    J, K = U.shape[1], Z.shape[1]
    S, F = np.zeros((J, J), ld), np.zeros((J, K), ld)
    d, w, x = ld(0), np.zeros(J, ld), np.zeros(K, ld)
    out = np.empty(Z.shape, ld)
    for n in range(len(t)):
        p = np.exp(-c * (t[n] - t[n - 1])) if n else np.zeros(J, ld)
        S = (S + d * np.outer(w, w)) * p[:, None] * p[None, :]
        F = p[:, None] * (F + np.outer(w, x))
        tmp = S @ U[n]
        d = a[n] - U[n] @ tmp
        w = (V[n] - tmp) / (d if d > 0 else ld(1))
        x = np.sqrt(max(d, ld(0))) * Z[n]
        out[n] = x + U[n] @ F
    return torch.from_numpy(out.astype(np.float64))


def joint_prior(cond, reg):
    """The joint prior's system ``(t_u, c, a, U, V)`` of ``cond`` at jitter
    ``reg``, as ``_pathwise_core`` builds it."""
    st = cond.gp.state
    t_u, _, _ = tgp._union(st.t, cond.t)
    diag = torch.zeros_like(t_u) + (reg or 0.0)
    return tgp._system(cond.gp.kernel, t_u, diag)


def prior_draw(system, Z):
    """``(L sqrt(d) Z, d)`` of the joint prior on the current tier."""
    t_u, c, a, U, V = system
    d, W = cs.ct.ops.factor(t_u, c, a, U, V)
    return tgp._dot_tril(t_u, c, U, d, W, Z), d


def normals(n):
    return torch.randn(n, 2, generator=torch.Generator().manual_seed(Z_SEED),
                       dtype=torch.float64)


def cpu_reading(label, reg):
    """The CPU route's draws of model ``label`` at jitter ``reg``, the long
    double prior draw, the CPU route's error against it and the smallest
    pivot over the variance."""
    cs.ct.set_config(device="cpu")
    torch.set_num_threads(1)
    t, y, t_new, _ = cs.gp_data(cs.N_MAIN)
    cond, S = cs.pathwise_conditional(label, *map(torch.tensor, (t, y, t_new)))
    draws = cond.sample_pathwise(torch.Generator().manual_seed(cs.PATHWISE_SEED),
                                 shape=(S,), regularize=reg)
    system = joint_prior(cond, reg)
    Z = normals(system[0].shape[0])
    got, d = prior_draw(system, Z)
    truth = longdouble_prior_draw(*system, Z)
    return {"draws": draws.numpy(), "truth": None if truth is None else truth.numpy(),
            "cpu_prior_err": None if truth is None else cs.scaled_err(got, truth),
            "min_pivot_over_variance": (d.min() / system[2].max()).item()}


def law_readings(N, M):
    """The ``--law`` readings on the CPU at N times and M targets."""
    cs.ct.set_config(device="cpu")
    rng = np.random.default_rng(42)
    span = N / 100
    t = np.sort(rng.uniform(0, span, N))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=N)
    t_new = np.linspace(-0.005 * span, 1.005 * span, M)
    for label, regs in JITTERS.items():
        cond, _ = cs.pathwise_conditional(label, *map(torch.tensor, (t, y, t_new)))
        cov = cond.covariance
        for reg in regs:
            system = joint_prior(cond, reg)
            Z = normals(system[0].shape[0])
            got, d = prior_draw(system, Z)
            truth = longdouble_prior_draw(*system, Z)
            # the map is affine in its normals: its columns at unit normals
            unit = torch.cat([torch.zeros(1, 2 * N + M, dtype=torch.float64),
                              torch.eye(2 * N + M, dtype=torch.float64)])
            draws = cond._pathwise_transform(unit[:, :N + M], unit[:, N + M:],
                                             regularize=reg)
            A = (draws[1:] - draws[0]).T
            print(json.dumps({
                "model": label, "regularize": reg, "N": N, "M": M,
                "min_pivot_over_variance": (d.min() / system[2].max()).item(),
                "cpu_prior_vs_longdouble": cs.scaled_err(got, truth),
                "law_vs_covariance": cs.scaled_err(A @ A.T, cov)}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--law", nargs=2, type=int, metavar=("N", "M"),
                        help="the law's readings on the CPU at N times, M targets")
    args = parser.parse_args(argv)
    if args.law:
        law_readings(*args.law)
        return 0
    if not torch.cuda.is_available():
        print("pathwise_jitter: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    tasks = [(label, reg) for label, regs in JITTERS.items() for reg in regs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(tasks), 7)) as pool:
        pending = pool.starmap_async(cpu_reading, tasks)
        cs._build.build()
        t, y, t_new, _ = cs.gp_data(cs.N_MAIN)
        t, y, t_new = (torch.tensor(x, device=dev) for x in (t, y, t_new))
        card = {}
        for label, regs in JITTERS.items():
            cond, S = cs.pathwise_conditional(label, t, y, t_new)
            for reg in regs:
                system = joint_prior(cond, reg)
                Z = normals(system[0].shape[0]).to(dev)
                for name in TIERS:
                    with cs.tier(name):
                        got, _ = prior_draw(system, Z)
                        draws = cond.sample_pathwise(
                            torch.Generator().manual_seed(cs.PATHWISE_SEED),
                            shape=(S,), regularize=reg)
                    card[label, reg, name] = (got.cpu(), draws.cpu())
        cpu = dict(zip(tasks, pending.get(timeout=1500)))
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        for (label, reg), ref in cpu.items():
            row = {"model": label, "regularize": reg, "N": cs.N_MAIN,
                   "M": int(t_new.shape[0]), "device": smi,
                   "min_pivot_over_variance": ref["min_pivot_over_variance"],
                   "cpu_prior_vs_longdouble": ref["cpu_prior_err"]}
            for name in TIERS:
                got, draws = card[label, reg, name]
                row[f"card_{name}_prior_vs_longdouble"] = (
                    None if ref["truth"] is None
                    else cs.scaled_err(got, torch.from_numpy(ref["truth"])))
                row[f"card_{name}_draws_vs_cpu"] = cs.scaled_err(
                    draws, torch.from_numpy(ref["draws"]))
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
