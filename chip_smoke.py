"""Smoke test of celerite2_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``celerite2_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main
path (the value and theta-gradient of ``gp_loglik`` for a SHOTerm at
N = 100,000) through them, checks it against the plain route on the CPU
in float64, and times a few chained sampler steps.  Run from the root of
the repository:

    python3 chip_smoke.py            # the smoke test (about a minute)
    python3 chip_smoke.py --sweep    # also time evals/s per block length

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a CUDA device the script
exits with status 1 and prints no result.
"""

import argparse
import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

import celerite2_torch as ct
from celerite2_torch.ops import _build
from celerite2_torch.ops import fused_loglik as fl

KERNELS = {
    "kalman_fwd": (fl.kalman_fwd_plain, _build.kalman_fwd_cuda),
    "solve_rev": (fl.solve_rev_plain, _build.solve_rev_cuda),
    "factor_rev": (fl.factor_rev_plain, _build.factor_rev_cuda),
}
TPU_KERNEL = "celerite2_tpu/ops/fused_slab.py:308"
SOURCE = "celerite2_torch/csrc/fused_loglik.cu"
THETA0 = np.log([1.0, 5.0, 3.0])
N_MAIN = 100_000
# float32 against the float64 reference: a value summed over 1e5 rows
# and gradients of a 1e5-step recursion in float32 keep about three to
# four digits (the JAX package's TPU float32 against CPU float64 check
# uses 1e-3 relative for the same quantities)
F32_RTOL = 1e-3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def sho(theta):
    return ct.SHOTerm(sigma=theta[..., 0].exp(), rho=theta[..., 1].exp(),
                      tau=theta[..., 2].exp())


def bench_data(N, device, dtype, seed=42):
    """The benchmark's data: t ~ sort(U(0, 1000)), y = sin(0.7 t) + noise."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1000, N))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=N)
    return (torch.tensor(t, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device))


def value_and_grad(theta, t, y, **kw):
    theta = theta.detach().requires_grad_(True)
    ll = ct.gp_loglik(sho(theta), t, y, yerr=0.25, **kw)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    return ll.detach(), g


def scaled_err(got, want):
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-300)).item()


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextmanager
def plain_route():
    """Route the three passes to their plain versions on CUDA tensors
    (for timing the plain route on the card; never used by the port)."""
    saved = (fl.kalman_fwd, fl.solve_rev, fl.factor_rev)
    fl.kalman_fwd, fl.solve_rev, fl.factor_rev = (
        fl.kalman_fwd_plain, fl.solve_rev_plain, fl.factor_rev_plain
    )
    try:
        yield
    finally:
        fl.kalman_fwd, fl.solve_rev, fl.factor_rev = saved


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    log("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" | CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    return smi


def phase_build():
    start = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - start
    log("build", f"{lib.name} ready in {seconds:.1f} s")
    name, spills = "?", "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        if line.startswith("build_seconds"):
            log("build", f"nvcc took {line.split()[1]} s")
        elif m := re.search(r"([a-z]+_[a-z]+)_kernelI([fd])Li(\d)E", line):
            name = f"{m[1]}<{'double' if m[2] == 'd' else 'float'}, J={m[3]}>"
        elif "spill stores" in line:
            spills = line.split(",")[1].strip()
        elif m := re.search(r"Used (\d+) registers", line):
            log("build", f"{name}: {m[1]} registers, {spills}")


def system(J, N, C, device, seed=0):
    """A J = 1 (RealTerm) or J = 2 (SHOTerm) system of C chains."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, 1000, N)), device=device,
                     dtype=torch.float64)
    scale = torch.tensor(rng.uniform(0.8, 1.2, C), device=device,
                         dtype=torch.float64)
    if J == 1:
        kernel = ct.RealTerm(a=scale, c=0.3)
    else:
        kernel = ct.SHOTerm(sigma=scale, rho=5.0, tau=3.0)
    c, a, U, V = kernel.get_celerite_matrices(t, 0.0625)
    y = torch.tensor(np.sin(0.7 * t.cpu().numpy()) + 0.25 * rng.normal(size=(C, N)),
                     device=device)
    return t, c, a, U, V, y


def phase_kernels(dev):
    """Each kernel against its plain version on the card, float64."""
    worst = dict.fromkeys(KERNELS, 0.0)
    main_abs = {}
    main_inputs = None
    for J in (1, 2):
        for N, C in ((130, 1), (1040, 1), (N_MAIN, 1), (3001, 8)):
            args = system(J, N, C, dev, seed=N + J)
            L = fl.default_block_len(N)
            inputs = fl.pass_inputs(*args)
            for name, (plain, kernel) in KERNELS.items():
                got = kernel(*inputs[name], L)
                want = plain(*inputs[name], L)
                for g, w in zip(got, want):
                    err = scaled_err(g, w)
                    worst[name] = max(worst[name], err)
                    assert math.isfinite(err) and err < 1e-10, (name, J, N, C, err)
                if (J, N, C) == (2, N_MAIN, 1):
                    main_abs[name] = max(
                        (g - w).abs().max().item() for g, w in zip(got, want)
                    )
            if (J, N, C) == (2, N_MAIN, 1):
                main_inputs = inputs
    for name in KERNELS:
        log("kernels", f"{name}: worst relative error {worst[name]:.3e} "
            "(J = 1, 2; N = 130, 1040, 1e5 at C = 1; N = 3001 at C = 8)")
    # times at the main path's shapes (J = 2, N = 1e5, C = 1, float64)
    times = {}
    L = fl.default_block_len(N_MAIN)
    for name, (plain, kernel) in KERNELS.items():
        inp = main_inputs[name]
        ms = cuda_ms(lambda: kernel(*inp, L), reps=20)
        plain_ms = cuda_ms(lambda: plain(*inp, L), reps=3, warmup=1)
        times[name] = (ms, plain_ms)
        log("kernels", f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms) at "
            f"N = 1e5, J = 2, L = {L}, float64")
    return main_abs, times


def phase_main_path(dev):
    """gp_loglik value and theta-gradient at N = 1e5 through the kernels."""
    theta = torch.tensor(THETA0, dtype=torch.float64)
    t, y = bench_data(N_MAIN, "cpu", torch.float64)
    v_ref, g_ref = value_and_grad(theta, t, y)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    results = {}
    for dtype in (torch.float64, torch.float32):
        td, yd = bench_data(N_MAIN, dev, dtype)
        v, g = value_and_grad(theta.to(dev, dtype), td, yd)
        torch.cuda.synchronize()
        results[dtype] = (v, g)
    launches = dict(_build.LAUNCHES)
    for dtype, (v, g) in results.items():
        ev = scaled_err(v, v_ref)
        eg = scaled_err(g, g_ref)
        tol_v, tol_g = (1e-9, 1e-9) if dtype == torch.float64 else (F32_RTOL,) * 2
        log("main", f"{dtype}: ll {v.item():.10g} (ref {v_ref.item():.10g}), "
            f"value err {ev:.2e}, grad err {eg:.2e} (tol {tol_v:g})")
        assert v.dtype == dtype and g.shape == (3,)
        assert torch.isfinite(v).all() and torch.isfinite(g).all()
        assert ev < tol_v and eg < tol_g, (dtype, ev, eg)
    log("main", f"launches {launches}")
    for name, n in launches.items():
        assert n >= 1, f"{name} was not launched on the main path"
    return launches


def phase_chains(dev):
    """64 chains at N = 3e4 in one call, against a loop over chains."""
    C, N = 64, 30_000
    rng = np.random.default_rng(7)
    theta = torch.tensor(THETA0 + 0.1 * rng.normal(size=(C, 3)), device=dev)
    t, y = bench_data(N, dev, torch.float64, seed=8)
    v, g = value_and_grad(theta, t, y)
    assert v.shape == (C,) and g.shape == (C, 3)
    loop = [value_and_grad(theta[k], t, y) for k in range(C)]
    ev = scaled_err(v, torch.stack([x[0] for x in loop]))
    eg = max(scaled_err(g[k], loop[k][1]) for k in range(C))
    log("chains", f"C = {C}, N = {N}: batched vs loop value err {ev:.2e}, "
        f"grad err {eg:.2e}")
    assert ev < 1e-10 and eg < 1e-10


def phase_quiet_failure(dev):
    t, y = bench_data(2000, dev, torch.float64)
    theta = torch.tensor(THETA0, device=dev).requires_grad_(True)
    ll = ct.gp_loglik(sho(theta), t, y, diag=-5.0)
    (g,) = torch.autograd.grad(ll, theta)
    log("quiet", f"non-PD system: ll = {ll.item()}, grad = {g.tolist()}")
    assert ll.item() == -math.inf and torch.all(g == 0)


def steps_per_s(dev, dtype, n_steps=20, block_len=None):
    """Chained value+grad evaluations theta <- theta + 1e-9 g at N = 1e5,
    through gp_loglik (or, given ``block_len``, through loglik_fused with
    that block length), after two warm-up steps."""
    t, y = bench_data(N_MAIN, dev, dtype)

    def step(theta):
        theta = theta.detach().requires_grad_(True)
        if block_len is None:
            ll = ct.gp_loglik(sho(theta), t, y, yerr=0.25)
        else:
            c, a, U, V = sho(theta).get_celerite_matrices(t, 0.0625)
            ll = fl.loglik_fused(t, c[None], a[None], U[None], V[None],
                                 y[None], block_len=block_len)
        (g,) = torch.autograd.grad(ll.sum(), theta)
        return theta + 1e-9 * g

    theta = torch.tensor(THETA0, device=dev, dtype=dtype)
    for _ in range(2):
        theta = step(theta)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        theta = step(theta)
    end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(theta).all()
    return 1000.0 * n_steps / start.elapsed_time(end)


def phase_steps(dev):
    L = fl.default_block_len(N_MAIN)
    for dtype in (torch.float64, torch.float32):
        kernel = steps_per_s(dev, dtype)
        with plain_route():
            plain = steps_per_s(dev, dtype)
        log("steps", f"{dtype}: kernel route {kernel:.2f} evals/s, plain "
            f"route {plain:.3f} evals/s (20 chained steps, N = 1e5, SHOTerm, "
            f"L = {L})")


def phase_sweep(dev):
    """Per block length L: the three kernels' time at N = 1e5 (J = 2,
    float64) and the end-to-end evals/s in both dtypes."""
    inputs = fl.pass_inputs(*system(2, N_MAIN, 1, dev))
    for L in (32, 64, 128, 256, 512, 1024, 2048):
        ms = sum(
            cuda_ms(lambda: kernel(*inputs[name], L), reps=20)
            for name, (_, kernel) in KERNELS.items()
        )
        r64 = steps_per_s(dev, torch.float64, block_len=L)
        r32 = steps_per_s(dev, torch.float32, block_len=L)
        log("sweep", f"L = {L} (NB = {-(-N_MAIN // L)}): kernels {ms:.4f} ms, "
            f"float64 {r64:.2f} evals/s, float32 {r32:.2f} evals/s "
            "(N = 1e5, C = 1)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also time evals/s for several block lengths")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    main_abs, times = phase_kernels(dev)
    launches = phase_main_path(dev)
    phase_chains(dev)
    phase_quiet_failure(dev)
    phase_steps(dev)
    if args.sweep:
        phase_sweep(dev)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[name],
         "max_abs_err": main_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
