"""Smoke test of celerite2_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``celerite2_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the two main
paths through them and checks each against the plain route on the CPU in
float64:

* J = 2: the value and theta-gradient of ``gp_loglik`` for a SHOTerm at
  N = 100,000 (kernels K1, K2 and the dense factor adjoint K3);
* J = 4: the same for benchmarks/configs.py config5's SHO mixture and for
  a RotationTerm at N = 100,000 (K1, K2 and the structured factor adjoint
  K4, K5).

It then times chained sampler steps on both paths, config5's J = 4 model
at its own size N = 1e6, and profiles the J = 4 path.  Run from the root
of the repository:

    python3 chip_smoke.py            # the smoke test (a few minutes)
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
    "frev_maps": (fl.frev_maps_plain, _build.frev_maps_cuda),
    "frev_states": (fl.frev_states_plain, _build.frev_states_cuda),
}
TPU_KERNEL = {
    "kalman_fwd": "celerite2_tpu/ops/fused_slab.py:308",
    "solve_rev": "celerite2_tpu/ops/fused_slab.py:308",
    "factor_rev": "celerite2_tpu/ops/fused_slab.py:308",
    "frev_maps": "celerite2_tpu/ops/fused_slab.py:629",
    "frev_states": "celerite2_tpu/ops/fused_slab.py:697",
}
SOURCE = "celerite2_torch/csrc/fused_loglik.cu"
# the width at which each kernel is timed and reported: J = 4 (config5's
# SHO mixture), except the dense factor adjoint K3, which serves J <= 2
REPORT_J = {"kalman_fwd": 4, "solve_rev": 4, "factor_rev": 2,
            "frev_maps": 4, "frev_states": 4}
THETA0 = np.log([1.0, 5.0, 3.0])
THETA4 = np.zeros(5)  # config5's J4 starting point
THETA_ROT = np.log([1.0, 3.5, 2.0, 1.0, 0.3])  # config2's RotationTerm
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


def sho_mixture(theta):
    """benchmarks/configs.py config5's J = 4 model."""
    return sho(theta) + ct.SHOTerm(sigma=theta[..., 3].exp(),
                                   rho=theta[..., 4].exp(), Q=0.3)


def rotation(theta):
    e = theta.exp()
    return ct.RotationTerm(sigma=e[..., 0], period=e[..., 1], Q0=e[..., 2],
                           dQ=e[..., 3], f=e[..., 4])


def bench_data(N, device, dtype, seed=42, span=1000.0):
    """The benchmark's data: t ~ sort(U(0, span)), y = sin(0.7 t) + noise."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, span, N))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=N)
    return (torch.tensor(t, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device))


def value_and_grad(theta, t, y, model=sho, **kw):
    theta = theta.detach().requires_grad_(True)
    ll = ct.gp_loglik(model(theta), t, y, yerr=0.25, **kw)
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


def reset_launches():
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


@contextmanager
def plain_route():
    """Route the kernels to their plain versions on CUDA tensors (for
    timing the plain route on the card; never used by the port)."""
    names = list(KERNELS)
    saved = [getattr(fl, n) for n in names]
    for n in names:
        setattr(fl, n, KERNELS[n][0])
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(fl, n, f)


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


# kernels of each system kind: J = 1 RealTerm, 2 SHOTerm, 3 RealTerm +
# SHOTerm, 4 the SHO mixture and RotationTerm
def _system_kernel(kind, scale):
    sho_k = ct.SHOTerm(sigma=scale, rho=5.0, tau=3.0)
    return {
        "real": lambda: ct.RealTerm(a=scale, c=0.3),
        "sho": lambda: sho_k,
        "real_sho": lambda: ct.RealTerm(a=0.5 * scale, c=0.3) + sho_k,
        "sho_mixture": lambda: sho_k + ct.SHOTerm(sigma=0.5 * scale, rho=1.0,
                                                  Q=0.3),
        "rotation": lambda: ct.RotationTerm(sigma=scale, period=3.5, Q0=2.0,
                                            dQ=1.0, f=0.3),
    }[kind]()


def system(kind, N, C, device, seed=0):
    """A system of C chains with the kernel of ``kind``."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, 1000, N)), device=device,
                     dtype=torch.float64)
    scale = torch.tensor(rng.uniform(0.8, 1.2, C), device=device,
                         dtype=torch.float64)
    c, a, U, V = _system_kernel(kind, scale).get_celerite_matrices(t, 0.0625)
    y = torch.tensor(np.sin(0.7 * t.cpu().numpy()) + 0.25 * rng.normal(size=(C, N)),
                     device=device)
    return t, c, a, U, V, y


KINDS = (("real", 1), ("sho", 2), ("real_sho", 3), ("sho_mixture", 4),
         ("rotation", 4))
GEOMETRIES = ((130, 1), (1040, 1), (N_MAIN, 1), (3001, 8))


def phase_kernels(dev):
    """Each kernel against its plain version on the card, float64, at
    J = 1..4 (K3 at J <= 2; K4, K5 at J = 2..4); at J = 2 also the
    structured route's MX against K3's.  Then each kernel's time."""
    worst = {name: (0.0, set()) for name in KERNELS}
    worst_mx = 0.0
    main_abs, main_inputs = {}, {}
    for kind, J in KINDS:
        for N, C in GEOMETRIES:
            args = system(kind, N, C, dev, seed=N + J)
            L = fl.default_block_len(N)
            inputs = fl.pass_inputs(*args)
            if J == 2:
                inputs.update(fl.pass_inputs(*args, structured=True))
            for name, inp in inputs.items():
                plain, kernel = KERNELS[name]
                got, want = kernel(*inp, L), plain(*inp, L)
                if isinstance(got, torch.Tensor):
                    got, want = (got,), (want,)
                for g, w in zip(got, want):
                    assert g.shape == w.shape, (name, kind, N, C)
                    err = scaled_err(g, w)
                    assert math.isfinite(err) and err < 1e-10, (name, kind, N, C, err)
                    worst[name] = (max(worst[name][0], err), worst[name][1] | {J})
                main = (N, C) == (N_MAIN, 1) and J == REPORT_J[name] and kind in (
                    "sho", "sho_mixture")
                if main:
                    main_abs[name] = max(
                        (g - w).abs().max().item() for g, w in zip(got, want))
                    main_inputs[name] = inp
            if J == 2:
                fin = inputs["frev_maps"]
                dense = fl.factor_adjoint(*fin, L, structured=False)
                structured = fl.factor_adjoint(*fin, L, structured=True)
                err = scaled_err(structured, dense)
                assert err < 1e-10, ("MX", N, C, err)
                worst_mx = max(worst_mx, err)
    for name, (err, Js) in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = "
            f"{', '.join(map(str, sorted(Js)))}; N = 130, 1040, 1e5 at C = 1; "
            "N = 3001 at C = 8)")
    log("kernels", f"J = 2, structured (K4 -> B -> K5) vs dense (K3) MX on "
        f"the card: worst relative error {worst_mx:.3e}")
    times = {}
    L = fl.default_block_len(N_MAIN)
    for name, (plain, kernel) in KERNELS.items():
        inp = main_inputs[name]
        ms = cuda_ms(lambda: kernel(*inp, L), reps=20)
        plain_ms = cuda_ms(lambda: plain(*inp, L), reps=3, warmup=1)
        times[name] = (ms, plain_ms)
        log("kernels", f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms) at "
            f"N = 1e5, J = {REPORT_J[name]}, L = {L}, float64")
    # the J = 2 path's K1, K2 as PR 1 timed them
    j2 = fl.pass_inputs(*system("sho", N_MAIN, 1, dev, seed=N_MAIN + 2))
    for name in ("kalman_fwd", "solve_rev"):
        ms = cuda_ms(lambda: KERNELS[name][1](*j2[name], L), reps=20)
        log("kernels", f"{name}: {ms:.4f} ms at N = 1e5, J = 2, L = {L}, float64")
    return main_abs, times


def _check_path(label, results, refs, tols, nparam):
    """Each result (value, gradient) against its float64 CPU reference,
    relative to the reference's largest entry, within ``tols[key]``."""
    for key, (v, g) in results.items():
        v_ref, g_ref = refs[key]
        tol_v, tol_g = tols[key]
        ev, eg = scaled_err(v, v_ref), scaled_err(g, g_ref)
        log(label, f"{key}: ll {v.item():.10g} (ref {v_ref.item():.10g}), "
            f"value err {ev:.2e} (tol {tol_v:g}), grad err {eg:.2e} "
            f"(tol {tol_g:.3g})")
        assert g.shape == (nparam,)
        assert torch.isfinite(v).all() and torch.isfinite(g).all()
        assert ev < tol_v and eg < tol_g, (key, ev, eg)


def phase_main_path(dev):
    """J = 2: gp_loglik value and theta-gradient at N = 1e5 through K1,
    K2, K3."""
    theta = torch.tensor(THETA0, dtype=torch.float64)
    t, y = bench_data(N_MAIN, "cpu", torch.float64)
    ref = value_and_grad(theta, t, y)
    reset_launches()
    results = {}
    for dtype in (torch.float64, torch.float32):
        td, yd = bench_data(N_MAIN, dev, dtype)
        results[str(dtype)] = value_and_grad(theta.to(dev, dtype), td, yd)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    tols = {k: (1e-9,) * 2 if "64" in k else (F32_RTOL,) * 2 for k in results}
    _check_path("main J=2", results, dict.fromkeys(results, ref), tols, 3)
    log("main J=2", f"launches {launches}")
    for name in ("kalman_fwd", "solve_rev", "factor_rev"):
        assert launches[name] >= 1, f"{name} was not launched on the J = 2 path"
    return launches


def phase_main_path_j4(dev):
    """J = 4: gp_loglik value and theta-gradient at N = 1e5 through K1,
    K2, K4, K5, for config5's SHO mixture (float64, float32) and for a
    RotationTerm (float64)."""
    t, y = bench_data(N_MAIN, "cpu", torch.float64)
    th4 = torch.tensor(THETA4, dtype=torch.float64)
    thr = torch.tensor(THETA_ROT, dtype=torch.float64)
    ref4 = value_and_grad(th4, t, y, sho_mixture)
    refr = value_and_grad(thr, t, y, rotation)
    reset_launches()
    results = {}
    for dtype in (torch.float64, torch.float32):
        td, yd = bench_data(N_MAIN, dev, dtype)
        results[f"sho_mixture {dtype}"] = value_and_grad(
            th4.to(dev, dtype), td, yd, sho_mixture)
    td, yd = bench_data(N_MAIN, dev, torch.float64)
    results["rotation torch.float64"] = value_and_grad(thr.to(dev), td, yd, rotation)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    refs = {k: (refr if k.startswith("rotation") else ref4) for k in results}
    # At J = 4 the float32 gradient loses more than 1e-3 in the algorithm
    # itself (d/d rho sums t-weighted cotangents over 1e5 rows): the plain
    # route on the CPU, in float32, is the measure.  The card may be no
    # worse than 1.5 times that, or 1e-3, whichever is larger.
    t32, y32 = bench_data(N_MAIN, "cpu", torch.float32)
    cpu32 = scaled_err(value_and_grad(th4.float(), t32, y32, sho_mixture)[1],
                       ref4[1])
    log("main J=4", f"float32 plain route on the CPU: grad err {cpu32:.2e}")
    tols = {k: (1e-9, 1e-9) if "64" in k else (F32_RTOL, max(F32_RTOL, 1.5 * cpu32))
            for k in results}
    _check_path("main J=4", results, refs, tols, 5)
    log("main J=4", f"launches {launches} (3 evaluations)")
    for name in ("kalman_fwd", "solve_rev", "frev_maps", "frev_states"):
        assert launches[name] >= 1, f"{name} was not launched on the J = 4 path"
    assert launches["factor_rev"] == 0, "the J = 4 path launched K3"
    return launches


def phase_chains(dev):
    """64 chains at N = 3e4 in one call, against a loop over chains, at
    J = 2 and J = 4."""
    C, N = 64, 30_000
    rng = np.random.default_rng(7)
    t, y = bench_data(N, dev, torch.float64, seed=8)
    for model, theta0 in ((sho, THETA0), (sho_mixture, THETA4)):
        theta = torch.tensor(theta0 + 0.1 * rng.normal(size=(C, len(theta0))),
                             device=dev)
        v, g = value_and_grad(theta, t, y, model)
        assert v.shape == (C,) and g.shape == (C, len(theta0))
        loop = [value_and_grad(theta[k], t, y, model) for k in range(C)]
        ev = scaled_err(v, torch.stack([x[0] for x in loop]))
        eg = max(scaled_err(g[k], loop[k][1]) for k in range(C))
        log("chains", f"{model.__name__}, C = {C}, N = {N}: batched vs loop "
            f"value err {ev:.2e}, grad err {eg:.2e}")
        assert ev < 1e-10 and eg < 1e-10


def phase_quiet_failure(dev):
    t, y = bench_data(2000, dev, torch.float64)
    for model, theta0 in ((sho, THETA0), (sho_mixture, THETA4)):
        theta = torch.tensor(theta0, device=dev).requires_grad_(True)
        ll = ct.gp_loglik(model(theta), t, y, diag=-5.0)
        (g,) = torch.autograd.grad(ll, theta)
        log("quiet", f"non-PD {model.__name__}: ll = {ll.item()}, "
            f"grad = {g.tolist()}")
        assert ll.item() == -math.inf and torch.all(g == 0)


def steps_per_s(dev, dtype, n_steps=20, block_len=None, model=sho,
                theta0=THETA0, data=None):
    """Chained value+grad evaluations theta <- theta + 1e-9 g through
    gp_loglik (or, given ``block_len``, through loglik_fused with that
    block length), after two warm-up steps; ``data`` is (t, y) on the
    device (default: bench_data at N = 1e5)."""
    t, y = bench_data(N_MAIN, dev, dtype) if data is None else data

    def step(theta):
        theta = theta.detach().requires_grad_(True)
        if block_len is None:
            ll = ct.gp_loglik(model(theta), t, y, yerr=0.25)
        else:
            c, a, U, V = model(theta).get_celerite_matrices(t, 0.0625)
            ll = fl.loglik_fused(t, c[None], a[None], U[None], V[None],
                                 y[None], block_len=block_len)
        (g,) = torch.autograd.grad(ll.sum(), theta)
        return theta + 1e-9 * g

    theta = torch.tensor(theta0, device=dev, dtype=dtype)
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
        log("steps", f"J = 2, {dtype}: kernel route {kernel:.2f} evals/s, "
            f"plain route {plain:.3f} evals/s (20 chained steps, N = 1e5, "
            f"SHOTerm, L = {L})")
    for dtype in (torch.float64, torch.float32):
        kernel = steps_per_s(dev, dtype, model=sho_mixture, theta0=THETA4)
        with plain_route():
            plain = steps_per_s(dev, dtype, n_steps=3, model=sho_mixture,
                                theta0=THETA4)
        log("steps", f"J = 4, {dtype}: kernel route {kernel:.2f} evals/s "
            f"(20 chained steps), plain route {plain:.3f} evals/s (3 steps); "
            f"N = 1e5, config5 SHO mixture, L = {L}")
    # config5's own size: t ~ sort(U(0, 1e4)), N = 1e6, seed 11
    N = 1_000_000
    data = bench_data(N, dev, torch.float64, seed=11, span=10_000.0)
    torch.cuda.reset_peak_memory_stats()
    rate = steps_per_s(dev, torch.float64, n_steps=10, model=sho_mixture,
                       theta0=THETA4, data=data)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("steps", f"J = 4, torch.float64, N = 1e6 (config5 J4): kernel route "
        f"{rate:.2f} evals/s (10 chained steps, L = "
        f"{fl.default_block_len(N)}), peak device memory {peak:.2f} GiB")


def phase_profile(dev):
    """torch.profiler over 3 J = 4 evaluations at N = 1e5, float64:
    device kernels per evaluation, device busy time and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t, y = bench_data(N_MAIN, dev, torch.float64)
    theta = torch.tensor(THETA4, device=dev)
    value_and_grad(theta, t, y, sho_mixture)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            value_and_grad(theta, t, y, sho_mixture)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile", "no device events in the trace: not measured")
        return
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / n
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / n
    log("profile", f"J = 4, N = 1e5, float64: {len(kernels) / n:.0f} device "
        f"kernels per eval, device busy {busy / 1000:.3f} ms of a "
        f"{span / 1000:.3f} ms span per eval (idle share "
        f"{1 - busy / span:.3f}; under the profiler)")
    by_name = {}
    for e in kernels:
        name = next((k for k in KERNELS if f"{k}_kernel" in e.name), e.name[:60])
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log("profile", "per eval, device time by kernel (top 8): " + "; ".join(
        f"{k} x{c / n:.0f} {us / n / 1000:.4f} ms" for k, (c, us) in top))
    log("profile", "per eval, this repo's kernels: " + ", ".join(
        f"{k} {by_name[k][1] / n / 1000:.4f} ms" for k in KERNELS if k in by_name))


def phase_sweep(dev):
    """Per block length L: the three J = 2 kernels' time at N = 1e5
    (float64) and the end-to-end evals/s in both dtypes."""
    inputs = fl.pass_inputs(*system("sho", N_MAIN, 1, dev))
    names = ("kalman_fwd", "solve_rev", "factor_rev")
    for L in (32, 64, 128, 256, 512, 1024, 2048):
        ms = sum(
            cuda_ms(lambda: KERNELS[name][1](*inputs[name], L), reps=20)
            for name in names
        )
        r64 = steps_per_s(dev, torch.float64, block_len=L)
        r32 = steps_per_s(dev, torch.float32, block_len=L)
        log("sweep", f"L = {L} (NB = {-(-N_MAIN // L)}): kernels {ms:.4f} ms, "
            f"float64 {r64:.2f} evals/s, float32 {r32:.2f} evals/s "
            "(N = 1e5, C = 1, J = 2)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also time evals/s for several block lengths")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    smi = phase_device()
    phase_build()
    main_abs, times = phase_kernels(dev)
    launches = phase_main_path(dev)
    launches4 = phase_main_path_j4(dev)
    phase_chains(dev)
    phase_quiet_failure(dev)
    phase_steps(dev)
    phase_profile(dev)
    if args.sweep:
        phase_sweep(dev)
    log("done", f"{time.perf_counter() - start:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNEL[name],
         "launches": (launches if REPORT_J[name] == 2 else launches4)[name],
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
