"""Reads the sequence-sharded log-likelihood's value and theta-gradient
against a long-double reference, beside the single-rank routes, on one
NVIDIA GPU.

The models are ``chip_smoke.py``'s: ``wide8`` (J = 8, its Q = 0.5 term
stiff) at ``THETA0`` and config5's mixture (J = 4) at ``THETA4``, on
bench.py's data at N = 1e5 (yerr 0.25).  The reference runs the factor and
the lower solve row by row in numpy's long double with their tangents in
the three or five parameters (forward mode), on the same float64 celerite
matrices and their float64 tangents, in a CPU worker started at launch.
Beside it, in float64: the CPU's plain scan route and
``parallel.make_sharded_logdensity`` on one rank on the CPU (its reverse
flow walked row by row, as the card does; and once by the plain doubling
instead), the card's scan and assoc tiers (``gp_loglik``),
and ``make_sharded_logdensity`` on one rank and on 2 and 4 gloo ranks
spawned on the card (time-sharing it).
Each route's value and gradient are read against the reference, relative
to its largest entry.

    python3 sharded_readings.py

Writes one JSON object per route to ``chiprun_out/sharded_readings.jsonl``
and prints each.
"""

import datetime
import json
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import celerite2_torch as ct
from celerite2_torch.ops import prefix_engine as pe

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "sharded_readings.jsonl"
N = 100_000
MODELS = {"J=8": (cs.wide8, cs.THETA0), "J=4": (cs.sho_mixture, cs.THETA4)}
WORLDS = (2, 4)


def long_double(label):
    """The value and gradient of model ``label`` by the row recursion and
    its tangents in long double (float64 inputs)."""
    from torch.func import jvp

    ct.set_config(device="cpu")
    model, theta = MODELS[label]
    t, y = cs.bench_data(N, "cpu", torch.float64)
    th = torch.tensor(theta, dtype=torch.float64)

    def mats(x):
        return model(x).get_celerite_matrices(t, torch.full_like(t, 0.0625))

    P = th.numel()
    base = mats(th)
    tang = [jvp(mats, (th,), (torch.eye(P, dtype=torch.float64)[k],))[1] for k in range(P)]
    ld = np.longdouble
    c, a, U, V = (x.numpy().astype(ld) for x in base)
    dc, da, dU, dV = (np.stack([tg[i].numpy() for tg in tang]).astype(ld) for i in range(4))
    tn, yn = t.numpy().astype(ld), y.numpy().astype(ld)
    J = c.shape[0]
    S, dS = np.zeros((J, J), ld), np.zeros((P, J, J), ld)
    F, dF = np.zeros(J, ld), np.zeros((P, J), ld)
    w, dw = np.zeros(J, ld), np.zeros((P, J), ld)
    d, dd, z, dz = ld(1), np.zeros(P, ld), ld(0), np.zeros(P, ld)
    ll, dll = ld(0), np.zeros(P, ld)
    for n in range(N):
        if n:  # carry S and F over the gap, with their tangents
            dt = tn[n] - tn[n - 1]
            p = np.exp(-c * dt)
            dp = -dc * dt * p
            ww = np.outer(w, w)
            M = S + d * ww
            dM = (dS + dd[:, None, None] * ww[None]
                  + d * (dw[:, :, None] * w[None, None, :] + w[None, :, None] * dw[:, None, :]))
            S = p[:, None] * M * p[None, :]
            dS = (dp[:, :, None] * M[None] * p[None, None, :]
                  + p[None, :, None] * dM * p[None, None, :]
                  + p[None, :, None] * M[None] * dp[:, None, :])
            G = F + w * z
            dG = dF + dw * z + w[None] * dz[:, None]
            F, dF = p * G, dp * G[None] + p[None] * dG
        u, v, du, dv = U[n], V[n], dU[:, n], dV[:, n]
        Su = S @ u
        dSu = dS @ u + np.einsum("ij,kj->ki", S, du)
        d = a[n] - u @ Su
        dd = da[:, n] - du @ Su - dSu @ u
        w = (v - Su) / d
        dw = (dv - dSu) / d - w[None] * (dd / d)[:, None]
        z = yn[n] - u @ F
        dz = -(du @ F) - dF @ u
        ll += -0.5 * (np.log(d) + z * z / d)
        dll += -0.5 * (dd / d + 2 * z * dz / d - z * z * dd / d**2)
    ll += -0.5 * N * np.log(ld(2) * np.pi)
    return float(ll), [float(x) for x in dll]


def _doubled(A, b, *, reverse=False, x0=None, total=False):
    """``prefix_engine.mat_affine_walk``'s arguments, computed by the plain
    doubling instead."""
    if total:
        return pe.mat_affine_total_plain(A, b, reverse=reverse)
    return pe.mat_affine_prefix_plain(A, b, reverse=reverse, x0=x0)


def cpu_routes():
    """The long-double references and the CPU's float64 plain routes, a
    model each: ``{label: ((ll, grad) long double, {route: (ll, grad)})}``;
    the routes are the plain scan and ``make_sharded_logdensity`` on one
    rank, its reverse flow (D = J^2 + 2J + 1) walked row by row as the
    card's ``ma_wide`` walks it above D = 32, and once more with the flow
    by ``prefix_engine.mat_affine_prefix_plain``'s doubling instead."""
    from celerite2_torch.parallel import make_sharded_logdensity

    out = {}
    for label, (model, theta) in MODELS.items():
        ref = long_double(label)
        t, y = cs.bench_data(N, "cpu", torch.float64)
        ll, g = cs.value_and_grad(torch.tensor(theta), t, y, model)
        routes = {"cpu plain route": (ll.item(), g.tolist())}
        logd = make_sharded_logdensity(model, t.numpy(), y.numpy(), 0.25, None,
                                       device="cpu")
        walk = pe.mat_affine_walk
        for route, flow in (("cpu sharded, 1 rank", walk),
                            ("cpu sharded, 1 rank, the flow by doubling", _doubled)):
            pe.mat_affine_walk = flow
            try:
                th = torch.tensor(theta, requires_grad=True)
                lls = logd(th)
                (gs,) = torch.autograd.grad(lls, th)
            finally:
                pe.mat_affine_walk = walk
            routes[route] = (lls.item(), gs.tolist())
        out[label] = (ref, routes)
    return out


def _worker(queue):
    torch.set_num_threads(4)
    queue.put(cpu_routes())


def rank_main(rank, world, init, out_file):
    """One of ``world`` gloo ranks on the card: the sharded value and
    gradient of each model; rank 0 saves them."""
    from celerite2_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    initialize_distributed("gloo", init_method=init, world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(chains=1, seq=world)
    res = {}
    for label, (model, theta) in MODELS.items():
        t, y = cs.bench_data(N, "cpu", torch.float64)
        ll, g, ms, *_ = cs._sharded_loglik_call(mesh, model, theta, t.numpy(), y.numpy(),
                                                dev)
        res[label] = (ll, g.tolist(), ms)
    if rank == 0:
        torch.save(res, out_file)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("sharded_readings: no CUDA device", file=sys.stderr)
        return 1
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    worker = ctx.Process(target=_worker, args=(queue,))
    worker.start()
    smi = cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    got = {}
    for label, (model, theta) in MODELS.items():
        t, y = cs.bench_data(N, dev, torch.float64)
        for tier in ("scan", "assoc"):
            with cs.tier(tier):
                ll, g = cs.value_and_grad(torch.tensor(theta, device=dev), t, y, model)
            got[(label, f"card {tier} tier")] = (ll.item(), g.tolist())
        from celerite2_torch.parallel import make_sharded_logdensity

        logd = make_sharded_logdensity(model, t.cpu().numpy(), y.cpu().numpy(), 0.25, None,
                                       device=dev)
        th = torch.tensor(theta, device=dev, requires_grad=True)
        ll = logd(th)
        (g,) = torch.autograd.grad(ll, th)
        got[(label, "card sharded, 1 rank")] = (ll.item(), g.tolist())
    torch.cuda.empty_cache()
    for world in WORLDS:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(
                rank_main, args=(world, f"file://{tmp}/rendezvous", f"{tmp}/out.pt"),
                nprocs=world, join=True)
            for label, (ll, g, _) in torch.load(f"{tmp}/out.pt").items():
                got[(label, f"card sharded, {world} gloo ranks")] = (ll, g)
    refs = queue.get(timeout=1800)
    worker.join()
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        for label, ((ll_ref, g_ref), cpu) in refs.items():
            routes = {**cpu, **{r: v for (m, r), v in got.items() if m == label}}
            g_ref = np.asarray(g_ref)
            for route, (ll, g) in routes.items():
                row = {"model": label, "route": route, "N": N, "card": smi,
                       "value_err": abs(ll - ll_ref) / abs(ll_ref),
                       "grad_err": float(np.abs(np.asarray(g) - g_ref).max()
                                         / np.abs(g_ref).max()),
                       "ll": ll, "ll_long_double": ll_ref, "time": time.time()}
                print(json.dumps(row), flush=True)
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
