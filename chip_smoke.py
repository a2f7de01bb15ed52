"""Smoke test of celerite2_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``celerite2_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the three main
paths through them and checks each against the plain route on the CPU in
float64:

* J = 2: the value and theta-gradient of ``gp_loglik`` for a SHOTerm at
  N = 100,000 (kernels K1, K2 and the dense factor adjoint K3);
* J = 4: the same for benchmarks/configs.py config5's SHO mixture and for
  a RotationTerm at N = 100,000 (K1, K2 and the structured factor adjoint
  K4, K5);
* the forward ``GaussianProcess`` path (compute, log_likelihood,
  apply_inverse, predict, sample) at N = 100,000 for a J = 8 model of four
  SHOTerms and for the J = 4 SHO mixture (the general factor and sweep
  kernels, ``factor_fwd`` and ``sweep_fwd``, and the blocked prefix of the
  rectangular products, ``affine_prefix``);
* the training path at J = 8: the value and theta-gradient of
  ``gp_loglik`` for the same four SHOTerms at N = 100,000, one chain and 64
  chains at N = 30,000, and the gradient of
  ``GaussianProcess.log_likelihood`` (``factor_fwd`` and ``sweep_fwd`` with
  their caches, then the adjoint kernels ``sweep_bwd`` and ``factor_bwd``);
* the assoc tier (``set_config(backend="assoc")``): the same GP and
  training calls at J = 8, N = 100,000 through the blocked prefix kernels
  ``riccati_prefix``, ``kalman_prefix`` and ``mat_affine_prefix`` (and
  ``affine_prefix``), each held against its plain version, timed against
  its bound, and the crossover between the two tiers that sets "auto".

Every phase before the assoc phase pins ``backend="scan"``, the sequential
tier its launch counts and times assume.

It then times chained sampler steps on the J = 2, 4 and 8 paths, config5's
J = 4 model at its own size N = 1e6, and profiles the J = 4 and J = 8
paths.  Run from the root of the repository:

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
import multiprocessing
import queue
import re
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch

import celerite2_torch as ct
from celerite2_torch.ops import _build
from celerite2_torch.ops import assoc
from celerite2_torch.ops import dispatch
from celerite2_torch.ops import fused_loglik as fl
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan

# the kernels of the fused log-likelihood: (plain version, wrapper)
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
    "factor_fwd": "celerite2_tpu/ops/pallas_kernels.py:139",
    "sweep_fwd": "celerite2_tpu/ops/pallas_kernels.py:236",
    "affine_prefix": "celerite2_tpu/ops/planes_engine.py:311",
    "factor_bwd": "celerite2_tpu/ops/pallas_kernels.py:421",
    "sweep_bwd": "celerite2_tpu/ops/pallas_kernels.py:578",
    "riccati_prefix": "celerite2_tpu/ops/planes_engine.py:311",
    "kalman_prefix": "celerite2_tpu/ops/planes_engine.py:311",
    "mat_affine_prefix": "celerite2_tpu/ops/planes_engine.py:311",
}
GENERAL = ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd", "affine_prefix")
ASSOC = ("riccati_prefix", "kalman_prefix", "mat_affine_prefix")
SOURCE = dict.fromkeys(KERNELS, "celerite2_torch/csrc/fused_loglik.cu")
SOURCE.update(dict.fromkeys(GENERAL, "celerite2_torch/csrc/general_ops.cu"))
SOURCE.update(dict.fromkeys(ASSOC, "celerite2_torch/csrc/assoc_prefix.cu"))
# Peak rates of one H100 SXM for the bound of each kernel: 3.35 TB/s of
# device memory; 67 TFLOP/s in float32 outside the tensor cores, and half
# of that in float64 (NVIDIA's data sheet: 34 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
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


def wide8(theta):
    """The J = 8 model of four SHOTerms (``wide_kernel(8, .)`` below,
    benchmarks/probe_planes_tpu.py's wide model) as a function of theta =
    log[sigma, rho, tau]: at THETA0 it is ``wide_kernel(8, 1.0)``; the
    last term's Q = 0.5 is the stiff near-critical case."""
    e = theta.exp()
    k = sho(theta)
    for j in range(3):
        k = k + ct.SHOTerm(sigma=e[..., 0] * (0.5 + 0.2 * j),
                           rho=e[..., 1] * (1.7 + j), Q=0.3 + 0.1 * j)
    return k


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


def bound_ms(arrays, flops):
    """The least time the card could take: each input read once and each
    output written once at the peak memory rate, or ``flops`` operations
    at the peak rate of the arrays' type, whichever is larger.  Returns
    ``(milliseconds, "bytes" or "operations")``."""
    nbytes = sum(x.numel() * x.element_size() for x in arrays)
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[arrays[0].dtype]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_flops(name, C, N, J, K=1):
    """Operations of one launch, counted from the recursions: per row, the
    element's build and one combine with the running value (K1-K3), one
    structured step on J^2 + 1 states (K4) or on one (K5), the rank-one
    update, transport and product of the factor, the transport, projection
    and feed of a sweep, one multiply-add of the affine prefix; for the
    adjoints, the factor's rank-one update, the reads of bS's row and
    column, its transport and the deferrals, and the sweep's projection,
    feed and three sums per right-hand side.  The assoc tier's prefixes:
    per row, the rank-one composition of the block maps (A, Q, R; b, eta)
    and the row step of the apply walk (Riccati, Kalman); the product of the
    block's J x J maps and the two walks (matrix-affine, D = J)."""
    D = J * J
    per_row = {
        "kalman_fwd": 12 * J**3 + 10 * D,
        "solve_rev": 2 * J**3 + 5 * D,
        "factor_rev": 2 * D**3 + 12 * D * D,
        "frev_maps": (D + 1) * 10 * D,
        "frev_states": 10 * D,
        "factor_fwd": 7 * D + 4 * J,
        "sweep_fwd": 5 * J * K,
        "affine_prefix": 2 * J * K,
        "factor_bwd": 13 * D + 10 * J,
        "sweep_bwd": 12 * J * K,
        "riccati_prefix": 26 * D,
        "kalman_prefix": 26 * D + 14 * J * K,
        "mat_affine_prefix": 2 * J**3 + 4 * D * K,
    }[name]
    return C * N * per_row


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
        elif m := re.search(r"([a-z]+_[a-z]+)_kernelI([fd])(?:Li(\d+))?E", line):
            name = f"{m[1]}<{'double' if m[2] == 'd' else 'float'}" + (
                f", J={m[3]}>" if m[3] else ">")
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
        plain_ms = cuda_ms(lambda: plain(*inp, L), reps=2, warmup=1)
        out = kernel(*inp, L)
        out = (out,) if isinstance(out, torch.Tensor) else out
        J = REPORT_J[name]
        bound, by = bound_ms((*inp, *out), kernel_flops(name, 1, N_MAIN, J))
        times[name] = (ms, plain_ms, bound, by)
        log("kernels", f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
            f"{bound:.4f} ms by {by}) at N = 1e5, J = {J}, L = {L}, float64")
    # the J = 2 path's K1, K2 as PR 1 timed them
    j2 = fl.pass_inputs(*system("sho", N_MAIN, 1, dev, seed=N_MAIN + 2))
    for name in ("kalman_fwd", "solve_rev"):
        ms = cuda_ms(lambda: KERNELS[name][1](*j2[name], L), reps=20)
        log("kernels", f"{name}: {ms:.4f} ms at N = 1e5, J = 2, L = {L}, float64")
    return main_abs, times


# ------------------------------------ the general factor and sweep kernels

# Kernel against plain version at N = 1e5: the J = 8 model has an SHOTerm at
# Q = 0.5, whose coefficients carry 1 / sqrt(eps) = 316, so the factor
# recursion amplifies the last-digit differences between the two (fused
# multiply-adds, the order of sums) some hundredfold over 1e5 rows
LONG_RTOL = 1e-9

MODES = {"solve_lower": (True, False), "solve_upper": (True, True),
         "matmul_lower": (False, False), "matmul_upper": (False, True)}


def wide_kernel(J, scale):
    """A kernel of width J: bench's SHOTerm plus (J - 2) / 2 more SHOTerms
    (benchmarks/probe_planes_tpu.py's wide model; J = 8 is its four
    SHOTerms), a RealTerm alone at J = 1 and one more at odd J."""
    if J == 1:
        return ct.RealTerm(a=scale, c=0.3)
    k = ct.SHOTerm(sigma=scale, rho=5.0, tau=3.0)
    for j in range((J - 2) // 2):
        k = k + ct.SHOTerm(sigma=scale * (0.5 + 0.2 * j), rho=5.0 * (1.7 + j),
                           Q=0.3 + 0.1 * j)
    if J % 2:
        k = k + ct.RealTerm(a=0.5 * scale, c=0.3)
    return k


def wide_system(J, N, C, K, dev, seed=0):
    """``(t (C, N), c, a, U, V, Y (C, N, K))`` of C chains of width J,
    padded to its bucket as the ops pad it (c = 1, zero columns)."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, N / 100.0, N)), device=dev)
    scale = torch.tensor(rng.uniform(0.8, 1.2, C), device=dev)
    c, a, U, V = wide_kernel(J, scale).get_celerite_matrices(t, 0.0625)
    c, (U, V), _ = ct.ops.api._bucketed(c, U, V)
    Y = torch.tensor(rng.normal(size=(C, N, K)), device=dev)
    return tuple(x.contiguous() for x in (t.expand(C, N), c, a, U, V, Y))


def sweep_args(mode, t, c, U, V, W):
    """``(p, A, B)`` of a sweep mode: the solves take W, the matmuls V; the
    upper sweeps project with the second matrix and feed with U."""
    is_solve, upper = MODES[mode]
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    p = scan.transport_up(t, c) if upper else scan.transport(t, c)
    return p, A, B


def held_at_main_shape(name, got, want, what):
    """A kernel's outputs against its plain version's at N = 1e5: the worst
    relative error (held to LONG_RTOL) and the largest absolute one."""
    err = max(scaled_err(g, w) for g, w in zip(got, want))
    log("kernels", f"{name} {what}: relative error at N = 1e5: {err:.3e} "
        f"(tol {LONG_RTOL:g})")
    assert math.isfinite(err) and err < LONG_RTOL, (name, what, err)
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def first_chain(xs):
    return tuple(x[:1].contiguous() for x in xs)


def randn_like(x, rng):
    return torch.tensor(rng.normal(size=tuple(x.shape)), device=x.device)


def hold_against_plain(checks, worst):
    """``checks``: (name, kernel outputs, plain outputs) triples, each
    output held to 1e-10 relative; ``worst[name]`` keeps the largest
    error."""
    for name, got, want in checks:
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, tuple(g.shape), tuple(w.shape))
            err = scaled_err(g, w)
            assert math.isfinite(err) and err < 1e-10, (name, tuple(g.shape), err)
            worst[name] = max(worst[name], err)


def timed_plain(fn):
    """One run of a plain version on the card: (result, milliseconds)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def phase_general_kernels(dev):
    """factor_fwd and sweep_fwd (its four modes) against their plain
    versions on the card, float64, caches included, to 1e-10 relative, at
    C = 8 and at C = 1 as the first of those chains (the plain version runs
    once on all eight); then their times at N = 1e5, J = 8, at C = 1 and
    C = 64, and each sweep shape the GP path launches against the plain
    version at N = 1e5.  The times and bounds reported are those of the
    call the GP path makes: without the caches."""
    worst = {"factor_fwd": 0.0, "sweep_fwd": 0.0}
    for J in (1, 2, 3, 8, 16, 32):
        for N in (130, 1040, 10_000):
            t, c, a, U, V, Y5 = wide_system(J, N, 8, 5, dev, seed=J + N)
            p = scan.transport(t, c)
            fin = (p, a, U, V)
            want = scan.factor_fwd_plain(*fin)
            W = want[1]
            checks = [
                ("factor_fwd", _build.factor_fwd_cuda(*fin, want_cache=True), want),
                ("factor_fwd", _build.factor_fwd_cuda(*first_chain(fin), True),
                 [w[:1] for w in want]),
            ]
            for mode, (is_solve, upper) in MODES.items():
                ps, A, B = sweep_args(mode, t, c, U, V, W)
                for Y in (Y5[..., :1].contiguous(), Y5):
                    sin = (ps, A, B, Y)
                    want = scan.sweep_fwd_plain(*sin, is_solve=is_solve, upper=upper)
                    checks += [
                        ("sweep_fwd", _build.sweep_fwd_cuda(*sin, is_solve, upper, True),
                         want),
                        ("sweep_fwd", _build.sweep_fwd_cuda(
                            *first_chain(sin), is_solve, upper, True),
                         [w[:1] for w in want]),
                    ]
            hold_against_plain(checks, worst)
    for name, err in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = 1, 2, "
            "3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8 and 1; K = 1, 5; "
            "caches included)")

    # times at the gp path's shapes: N = 1e5, J = 8, K = 1, float64
    main_abs, times = {}, {}
    for C in (1, 64):
        t, c, a, U, V, Y = wide_system(8, N_MAIN, C, 1, dev, seed=8)
        p = scan.transport(t, c)
        d, W, S = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
        ms_c = cuda_ms(lambda: _build.factor_fwd_cuda(p, a, U, V, True),
                       reps=5, warmup=1)
        ms = cuda_ms(lambda: _build.factor_fwd_cuda(p, a, U, V), reps=5, warmup=1)
        flops = kernel_flops("factor_fwd", C, N_MAIN, 8)
        bound, by = bound_ms((p, a, U, V, d, W), flops)
        bound_c, _ = bound_ms((p, a, U, V, d, W, S), flops)
        log("kernels", f"factor_fwd: {ms:.4f} ms (bound {bound:.4f} ms by {by}); "
            f"with the cache {ms_c:.4f} ms (bound {bound_c:.4f} ms) at N = 1e5, "
            f"J = 8, C = {C}, float64")
        if C == 1:
            want, plain_ms = timed_plain(lambda: scan.factor_fwd_plain(p, a, U, V))
            log("kernels", f"factor_fwd: plain version {plain_ms:.1f} ms (one run)")
            main_abs["factor_fwd"] = held_at_main_shape(
                "factor_fwd", (d, W, S), want, "d, W, S_half")
            times["factor_fwd"] = (ms, plain_ms, bound, by)
        for mode, (is_solve, upper) in MODES.items():
            ps, A, B = sweep_args(mode, t, c, U, V, W)
            Z, F = _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper, True)
            ms_c = cuda_ms(
                lambda: _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper, True),
                reps=5, warmup=1)
            ms = cuda_ms(lambda: _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper),
                         reps=5, warmup=1)
            flops = kernel_flops("sweep_fwd", C, N_MAIN, 8)
            bound, by = bound_ms((ps, A, B, Y, Z), flops)
            bound_c, _ = bound_ms((ps, A, B, Y, Z, F), flops)
            log("kernels", f"sweep_fwd {mode}: {ms:.4f} ms (bound {bound:.4f} ms by "
                f"{by}); with the cache {ms_c:.4f} ms (bound {bound_c:.4f} ms) at "
                f"N = 1e5, J = 8, K = 1, C = {C}, float64")
            if C == 1 and mode in ("solve_lower", "solve_upper"):
                want, plain_ms = timed_plain(lambda: scan.sweep_fwd_plain(
                    ps, A, B, Y, is_solve=True, upper=upper))
                log("kernels", f"sweep_fwd {mode}: plain version {plain_ms:.1f} ms "
                    "(one run)")
                err = held_at_main_shape("sweep_fwd", (Z, F), want, f"{mode} K = 1")
                if mode == "solve_lower":
                    main_abs["sweep_fwd"] = err
                    times["sweep_fwd"] = (ms, plain_ms, bound, by)
        if C == 1:
            # the other shapes the GP path launches: sample's matmul_lower
            # (K = 4) and the variance's solves on K = 500 columns (four
            # blocks of right-hand sides per chain)
            rng = np.random.default_rng(9)
            for mode, K in (("matmul_lower", 4), ("solve_lower", 500),
                            ("solve_upper", 500)):
                is_solve, upper = MODES[mode]
                ps, A, B = sweep_args(mode, t, c, U, V, W)
                YK = torch.tensor(rng.normal(size=(1, N_MAIN, K)), device=dev)
                Z, _ = _build.sweep_fwd_cuda(ps, A, B, YK, is_solve, upper)
                ms = cuda_ms(
                    lambda: _build.sweep_fwd_cuda(ps, A, B, YK, is_solve, upper),
                    reps=3, warmup=1)
                (want, _), plain_ms = timed_plain(lambda: scan.sweep_fwd_plain(
                    ps, A, B, YK, is_solve=is_solve, upper=upper))
                bound, by = bound_ms((ps, A, B, YK, Z),
                                     kernel_flops("sweep_fwd", 1, N_MAIN, 8, K))
                log("kernels", f"sweep_fwd {mode}, K = {K}: {ms:.4f} ms (bound "
                    f"{bound:.4f} ms by {by}; plain version {plain_ms:.1f} ms) at "
                    "N = 1e5, J = 8, C = 1, float64")
                held_at_main_shape("sweep_fwd", (Z,), (want,), f"{mode} K = {K}")
    return main_abs, times


def prefix_rows(phi, G, reverse):
    """The affine recurrence row by row (what the doubling and the kernel
    both compute)."""
    F, rows = torch.zeros_like(G[:, 0]), [None] * G.shape[1]
    for m in range(G.shape[1] - 1, -1, -1) if reverse else range(G.shape[1]):
        F = phi[:, m, :, None] * F + G[:, m]
        rows[m] = F
    return torch.stack(rows, 1)


def phase_prefix_kernel(dev):
    """affine_prefix against its plain version (the doubling) on the card,
    float64, to 1e-10 relative, in both directions, and against the
    row-by-row recurrence at M <= 1040; then its time at the shape the GP
    path gives it: M = 1e5 source rows, J = 8, K = 1."""
    worst = worst_rows = 0.0
    for J in (1, 3, 8, 32):
        for M in (1, 130, 1040, 10_000):
            for C, K in ((1, 1), (8, 5)):
                t, c, _, _, V, Y = wide_system(J, M, C, K, dev, seed=J + M)
                G = (V[..., None] * Y[..., None, :]).contiguous()
                for reverse in (False, True):
                    phi = scan.transport_up(t, c) if reverse else scan.transport(t, c)
                    got = _build.affine_prefix_cuda(phi, G, reverse)
                    want = scan.affine_prefix_plain(phi, G, reverse=reverse)
                    assert got.shape == want.shape, (J, M, C, K)
                    err = scaled_err(got, want)
                    assert math.isfinite(err) and err < 1e-10, (J, M, C, K, err)
                    worst = max(worst, err)
                    if M <= 1040:
                        err = scaled_err(got, prefix_rows(phi, G, reverse))
                        assert err < 1e-10, ("rows", J, M, C, K, err)
                        worst_rows = max(worst_rows, err)
    log("kernels", f"affine_prefix: worst relative error {worst:.3e} against "
        f"the doubling, {worst_rows:.3e} against the row-by-row recurrence "
        "(J = 1, 3 -> 4, 8, 32; M = 1, 130, 1040, 1e4; C, K = 1, 1 and 8, 5; "
        "both directions)")
    for C, K in ((1, 1), (64, 1), (1, 64)):
        t, c, _, _, V, Y = wide_system(8, N_MAIN, C, K, dev, seed=8)
        G = (V[..., None] * Y[..., None, :]).contiguous()
        phi = scan.transport(t, c)
        got = _build.affine_prefix_cuda(phi, G)
        want = scan.affine_prefix_plain(phi, G)
        err = scaled_err(got, want)
        assert math.isfinite(err) and err < 1e-10, ("affine_prefix", C, K, err)
        ms = cuda_ms(lambda: _build.affine_prefix_cuda(phi, G), reps=20)
        plain_ms = cuda_ms(lambda: scan.affine_prefix_plain(phi, G), reps=5)
        bound, by = bound_ms((phi, G, got),
                             kernel_flops("affine_prefix", C, N_MAIN, 8, K))
        log("kernels", f"affine_prefix: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms by {by}; relative error {err:.3e}) at "
            f"M = 1e5, J = 8, K = {K}, C = {C}, L = "
            f"{_build.prefix_block_len(N_MAIN)}, 3 launches, float64")
        if (C, K) == (1, 1):
            main_abs = (got - want).abs().max().item()
            times = (ms, plain_ms, bound, by)
    return {"affine_prefix": main_abs}, {"affine_prefix": times}


# ------------------------------------------- the adjoint kernels (training)


def adjoint_inputs(J, N, C, K, dev, seed, nonpositive=False, data_seed=None):
    """factor_bwd's inputs on the kernels' own forward cache with random
    cotangents (from ``seed``), and per sweep mode sweep_bwd's (K
    right-hand sides), for C chains of width J (padded to its bucket) of
    ``wide_system`` (``data_seed``, by default J + N + K).  With
    ``nonpositive`` some pivots are set to 0 and below, which both versions
    divide by 1."""
    rng = np.random.default_rng(seed)
    t, c, a, U, V, Y = wide_system(
        J, N, C, K, dev, seed=J + N + K if data_seed is None else data_seed)
    p = scan.transport(t, c)
    d, W, S = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
    if nonpositive:
        d = d.clone()
        d[:, ::7] = -d[:, ::7].abs()
        d[:, 3::11] = 0.0
    fin = (p, d, U, W, S, randn_like(d, rng), randn_like(W, rng))
    sins = {}
    for mode, (is_solve, upper) in MODES.items():
        ps, A, B = sweep_args(mode, t, c, U, V, W)
        Z, F = _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper, True)
        sins[mode] = (ps, A, B, Z if is_solve else Y, F, randn_like(Z, rng))
    return fin, sins


def adjoint_checks(fin, sins, whole=True, first=True, factor=True):
    """(name, kernel outputs, plain outputs) of factor_bwd (unless not
    ``factor``) and sweep_bwd in its four modes; with ``first`` also the
    first chain alone (the plain version runs once on all chains)."""
    def pair(name, kernel, plain, args):
        want = plain(*args)
        out = [(name, kernel(*args), want)] if whole else []
        if first:
            out.append((name, kernel(*first_chain(args)), [w[:1] for w in want]))
        return out

    checks = (pair("factor_bwd", _build.factor_bwd_cuda, scan.factor_bwd_plain,
                   fin) if factor else [])
    for mode, (is_solve, upper) in MODES.items():
        checks += pair(
            "sweep_bwd",
            lambda *a, s=is_solve, u=upper: _build.sweep_bwd_cuda(*a, s, u),
            lambda *a, s=is_solve, u=upper: scan.sweep_bwd_plain(
                *a, is_solve=s, upper=u),
            sins[mode])
    return checks


def hold_float32(checks32, checks64, worst):
    """Kernels run in float32 against the plain version in float64 (the
    same inputs, rounded): within 1e-4 relative or twice the plain
    version's own float32 error, the larger (sums in another order; the
    float32 gates of the paths are 1e-3)."""
    for (name, got, want32), (_, _, want64) in zip(checks32, checks64):
        for g, w32, w64 in zip(got, want32, want64):
            assert g.dtype == torch.float32 and g.shape == w64.shape, name
            err, own = scaled_err(g, w64), scaled_err(w32, w64)
            assert math.isfinite(err) and err <= max(1e-4, 2 * own), (
                name, tuple(g.shape), err, own)
            worst[name] = max(worst[name], err)


def to_float32(xs):
    return tuple(x.float() for x in xs)


def phase_adjoint_kernels(dev):
    """factor_bwd and sweep_bwd (four modes) against their plain versions
    on the card, float64, to 1e-10 relative, on the kernels' own forward
    caches and random cotangents: J = 1, 2, 3 -> 4, 8, 16, 32; N = 130,
    1040, 1e4; C = 8, and C = 1 as the first of those chains; K = 1, 5.
    Then the edges of their rings of row tiles: N = 1 and one row below and
    past a tile (C = 3; K = 1, 5, 200), 64 chains, blocks of several chains
    (the last one fewer), pivots d <= 0, and chains whose rows start off a
    16-byte boundary (odd N at J = 1, 2, in float32 and float64).  Then
    their times at N = 1e5, J = 8 (K = 1 in the four modes, and K = 5) at
    C = 1 and C = 64, and at C = 1024, N = 3e4 (K = 1, the lower solve's),
    with ns per row, and at C = 1 the factor and the lower solve's adjoint
    (the training path's shapes) against the plain versions to 1e-9
    (LONG_RTOL)."""
    worst = {"factor_bwd": 0.0, "sweep_bwd": 0.0}
    for J in (1, 2, 3, 8, 16, 32):
        for N in (130, 1040, 10_000):
            fin, sins = adjoint_inputs(J, N, 8, 5, dev, seed=J * N)
            sins1 = {m: s[:3] + tuple(x[..., :1].contiguous() for x in s[3:4])
                     + (s[4][..., :1].contiguous(), s[5][..., :1].contiguous())
                     for m, s in sins.items()}
            hold_against_plain(adjoint_checks(fin, sins), worst)
            hold_against_plain(adjoint_checks(fin, sins1, factor=False), worst)
    for name, err in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = 1, 2, "
            "3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8 and 1; K = 1, 5 in "
            "four modes)")

    # the rings' edges: rows per tile at each bucket, K and type
    edges = {"factor_bwd": 0.0, "sweep_bwd": 0.0}
    for J in (1, 2, 3, 8, 16, 32):
        Jb = J if J != 3 else 4
        for K in (1, 5, 200):
            rows = {_build.adjoint_ring(torch.float64, Jb, K, sweep=True)[0]}
            if K == 1:
                rows.add(_build.adjoint_ring(torch.float64, Jb)[0])
            for N in sorted({1} | {r + e for r in rows for e in (-1, 1)}):
                fin, sins = adjoint_inputs(J, N, 3, K, dev, seed=J + K)
                hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
        rings = ", ".join(
            f"{name} {dt} K = {K}: {r} rows, {b} B"
            for name, sweep, Ks in (("factor_bwd", False, (1,)),
                                    ("sweep_bwd", True, (1, 5, 200)))
            for K in Ks
            for dt, dtype in (("float64", torch.float64), ("float32", torch.float32))
            for r, _, b in (_build.adjoint_ring(dtype, Jb, K, sweep=sweep),))
        log("kernels", f"J = {J}: N = 1 and one row below and past a tile held; "
            f"tiles of the rings (shared memory per block): {rings}")
    fin, sins = adjoint_inputs(8, 1040, 64, 1, dev, seed=64)
    hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
    plans = ", ".join(
        f"C = {C}: " + " / ".join(
            "{1} ({0} rows)".format(*_build.adjoint_ring(torch.float64, 8, 1, C,
                                                          sweep))
            for sweep in (False, True))
        for C in (1, 264, 265, 300, 528, 529, 792, 793, 1024, 4096))
    log("kernels", "chains per block (rows per tile) of factor_bwd / sweep_bwd "
        f"at J = 8, K = 1, float64: {plans}")
    # blocks of several chains: 1023 chains (the last block fewer) over two
    # tiles at J = 2 and 8, K = 1 and 5
    for J in (2, 8):
        for K in (1, 5):
            plans = [_build.adjoint_ring(torch.float64, J, K, 1023, sweep)
                     for sweep in (False, True)]
            N = max(r for r, _, _ in plans) + 1
            fin, sins = adjoint_inputs(J, N, 1023, K, dev, seed=J * K)
            hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
            log("kernels", f"J = {J}, K = {K}, C = 1023, N = {N}: chains per "
                f"block (rows per tile) of factor_bwd, sweep_bwd: "
                + ", ".join(f"{c} ({r})" for r, c, _ in plans))
    fin, sins = adjoint_inputs(8, 1040, 3, 5, dev, seed=5, nonpositive=True)
    assert (fin[1] <= 0).any()
    hold_against_plain(adjoint_checks(fin, sins, first=False)[:1], edges)
    worst32 = {"factor_bwd": 0.0, "sweep_bwd": 0.0}
    for J in (1, 2):
        for N in (131, 1041):
            for K in (1, 5):
                fin, sins = adjoint_inputs(J, N, 3, K, dev, seed=N + K)
                hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
                checks64 = adjoint_checks(fin, sins, first=False)
                checks32 = adjoint_checks(
                    to_float32(fin), {m: to_float32(s) for m, s in sins.items()},
                    first=False)
                hold_float32(checks32, checks64, worst32)
    log("kernels", f"ring edges: worst relative error {edges} (float64: N = 1, "
        "tile +- 1 row, C = 3, K = 1, 5, 200; C = 64; C = 1023; pivots d <= 0; "
        f"odd N at J = 1, 2); float32 against the float64 plain version {worst32}")

    # times at the training path's shapes: N = 1e5, J = 8, float64
    main_abs, times = {}, {}
    per_row = 1e6 / N_MAIN  # ms per launch -> ns per row
    for C in (1, 64):
        fin, sins = adjoint_inputs(8, N_MAIN, C, 1, dev, seed=C, data_seed=8)
        got = _build.factor_bwd_cuda(*fin)
        ms = cuda_ms(lambda: _build.factor_bwd_cuda(*fin), reps=5, warmup=1)
        bound, by = bound_ms((*fin, *got), kernel_flops("factor_bwd", C, N_MAIN, 8))
        log("kernels", f"factor_bwd: {ms:.4f} ms, {ms * per_row:.1f} ns per row "
            f"(bound {bound:.4f} ms by {by}) at N = 1e5, J = 8, C = {C}, float64")
        if C == 1:
            want, plain_ms = timed_plain(lambda: scan.factor_bwd_plain(*fin))
            log("kernels", f"factor_bwd: plain version {plain_ms:.1f} ms (one run)")
            main_abs["factor_bwd"] = held_at_main_shape(
                "factor_bwd", got, want, "ba, bU, bV, bp")
            times["factor_bwd"] = (ms, plain_ms, bound, by)
        _, sins5 = adjoint_inputs(8, N_MAIN, C, 5, dev, seed=C, data_seed=8)
        for mode, (is_solve, upper) in MODES.items():
            for K, sin in ((1, sins[mode]), (5, sins5[mode])):
                got = _build.sweep_bwd_cuda(*sin, is_solve, upper)
                ms = cuda_ms(lambda: _build.sweep_bwd_cuda(*sin, is_solve, upper),
                             reps=5, warmup=1)
                bound, by = bound_ms((*sin, *got),
                                     kernel_flops("sweep_bwd", C, N_MAIN, 8, K))
                log("kernels", f"sweep_bwd {mode}: {ms:.4f} ms, "
                    f"{ms * per_row:.1f} ns per row (bound {bound:.4f} ms by "
                    f"{by}) at N = 1e5, J = 8, K = {K}, C = {C}, float64")
                if C == 1 and K == 1 and mode == "solve_lower":
                    want, plain_ms = timed_plain(lambda: scan.sweep_bwd_plain(
                        *sin, is_solve=True, upper=False))
                    log("kernels", f"sweep_bwd {mode}: plain version "
                        f"{plain_ms:.1f} ms (one run)")
                    main_abs["sweep_bwd"] = held_at_main_shape(
                        "sweep_bwd", got, want, f"{mode} K = 1")
                    times["sweep_bwd"] = (ms, plain_ms, bound, by)
    # a fleet of chains (the sampler's): C = 1024 at N = 3e4
    C, N = 1024, 30_000
    fin, sins = adjoint_inputs(8, N, C, 1, dev, seed=C, data_seed=8)
    sin = sins["solve_lower"]
    for name, fn in (("factor_bwd", lambda: _build.factor_bwd_cuda(*fin)),
                     ("sweep_bwd solve_lower",
                      lambda: _build.sweep_bwd_cuda(*sin, True, False))):
        ms = cuda_ms(fn, reps=5, warmup=1)
        bound, by = bound_ms((*(fin if name == "factor_bwd" else sin), *fn()),
                             kernel_flops(name.split()[0], C, N, 8))
        log("kernels", f"{name}: {ms:.4f} ms, {ms * 1e6 / N:.1f} ns per row "
            f"(bound {bound:.4f} ms by {by}) at N = 3e4, J = 8, K = 1, "
            f"C = {C}, float64")
    return main_abs, times


# ----------------------------------------- the forward GaussianProcess path


PLAIN_VERSIONS = (
    (scan, ("factor_fwd_plain", "sweep_fwd_plain", "factor_bwd_plain",
            "sweep_bwd_plain", "factor_solve_plain", "affine_prefix_plain")),
    (pe, ("riccati_prefix_plain", "kalman_prefix_plain",
          "mat_affine_prefix_plain")),
)


@contextmanager
def count_plain_versions():
    """Count the calls of the plain versions of the general recursions,
    their adjoints and the prefixes of both tiers."""
    counts = {n: 0 for _, names in PLAIN_VERSIONS for n in names}
    saved = [(mod, n, getattr(mod, n)) for mod, names in PLAIN_VERSIONS
             for n in names]

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, n, fn in saved:
        setattr(mod, n, counting(n, fn))
    try:
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


GP_MODELS = {
    # four SHOTerms (benchmarks/probe_planes_tpu.py's J = 8 model at bench's
    # theta) and config5's J = 4 SHO mixture at theta = 0
    "J=8": lambda: wide_kernel(8, 1.0),
    "J=4": lambda: ct.SHOTerm(sigma=1.0, rho=1.0, tau=1.0)
    + ct.SHOTerm(sigma=1.0, rho=1.0, Q=0.3),
}


def gp_calls(gp, y, t_new, t_var, seed):
    """The path a user who conditions and predicts runs, after compute:
    name -> (result, seconds).  The prior draws use the same normals on
    every device (a CPU generator)."""
    out = {}

    def timed(name, fn):
        if y.is_cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        res = fn()
        if y.is_cuda:
            torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - start)

    timed("log_likelihood", lambda: gp.log_likelihood(y))
    timed("apply_inverse", lambda: gp.apply_inverse(y))
    timed("predict(y)", lambda: gp.predict(y))
    timed("predict(y, t_new) M=1e4", lambda: gp.predict(y, t_new))
    timed("predict(y, t_new, return_var) M=500",
          lambda: torch.stack(gp.predict(y, t_var, return_var=True)))
    timed("sample(size=4)",
          lambda: gp.sample(torch.Generator().manual_seed(seed), size=4))
    return out


def gp_data(N):
    """bench.py's data at N rows, and the new points of the predictions."""
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, N))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=N)
    return t, y, np.linspace(-5.0, 1005.0, 10_000), np.linspace(-5.0, 1005.0, 500)


# --------------------------------------------- the CPU's plain route, aside


def cpu_references(N):
    """What the GP path and the training path are held against, on the
    CPU's plain route in float64 at N rows, as numpy: per GP model the
    state's d, W and each call's (result, seconds); for the training path
    gp_loglik's value and theta-gradient for wide8 at THETA0 on bench's
    data, and its seconds, on the scan tier ("train") and on the assoc
    tier ("train assoc"); for the J = 8 model also the state and three
    calls on the assoc tier ("J=8 assoc")."""
    ct.set_config(device="cpu")
    torch.set_num_threads(2)
    t, y, t_new, t_var = gp_data(N)
    out = {}
    for label, model in GP_MODELS.items():
        gp = ct.GaussianProcess(model(), t, yerr=0.25, mean=0.1, device="cpu")
        calls = gp_calls(gp, torch.tensor(y), t_new, t_var, seed=3)
        out[label] = (gp.state.d.numpy(), gp.state.W.numpy(),
                      {k: (v.numpy(), sec) for k, (v, sec) in calls.items()})
    tt, yy = bench_data(N, "cpu", torch.float64)
    start = time.perf_counter()
    v, g = value_and_grad(torch.tensor(THETA0), tt, yy, wide8)
    out["train"] = (v.numpy(), g.numpy(), time.perf_counter() - start)
    # the same on the CPU's plain assoc route (the doublings): how far the
    # assoc algorithm itself lies from the sequential one at this size
    ct.set_config(backend="assoc")
    gp = ct.GaussianProcess(GP_MODELS["J=8"](), t, yerr=0.25, mean=0.1,
                            device="cpu")
    yt = torch.tensor(y)
    out["J=8 assoc"] = (gp.state.d.numpy(), gp.state.W.numpy(), {
        "log_likelihood": gp.log_likelihood(yt).numpy(),
        "apply_inverse": gp.apply_inverse(yt).numpy(),
        "predict(y)": gp.predict(yt).numpy()})
    start = time.perf_counter()
    v, g = value_and_grad(torch.tensor(THETA0), tt, yy, wide8)
    out["train assoc"] = (v.numpy(), g.numpy(), time.perf_counter() - start)
    return out


def _cpu_references_worker(queue, N):
    try:
        queue.put(("ok", cpu_references(N)))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


class CpuReferences:
    """cpu_references(N) in a worker process, started at once, so that the
    CPU's plain route (minutes at N = 1e5) runs beside the card's phases."""

    def __init__(self, N):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_cpu_references_worker,
                                 args=(self._queue, N), daemon=True)
        self._proc.start()
        self._result = None

    def get(self):
        if self._result is None:
            deadline = time.monotonic() + 1000
            while True:
                try:
                    status, result = self._queue.get(timeout=5)
                    break
                except queue.Empty:
                    # a worker that put its result and exited has left it
                    # in the queue; one that died before has not
                    if not self._proc.is_alive():
                        status, result = self._queue.get(timeout=5)
                        break
                    if time.monotonic() > deadline:
                        raise
            self._proc.join(timeout=60)
            if status != "ok":
                raise RuntimeError(f"the CPU references failed:\n{result}")
            self._result = result
        return self._result

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=30)


def phase_gp_path(dev, smi, refs):
    """GaussianProcess.compute, log_likelihood, apply_inverse, predict and
    sample at N = 1e5, float64, through factor_fwd, sweep_fwd and
    affine_prefix, against the same calls on the CPU's plain route to 1e-9
    relative."""
    t, y, t_new, t_var = gp_data(N_MAIN)
    launches = {}
    for label, model in GP_MODELS.items():
        ref_d, ref_W, ref = refs.get()[label]
        ref_d, ref_W = torch.from_numpy(ref_d), torch.from_numpy(ref_W)
        ref = {k: (torch.from_numpy(v), sec) for k, (v, sec) in ref.items()}

        reset_launches()
        with count_plain_versions() as plain_calls:
            torch.cuda.synchronize()
            start = time.perf_counter()
            gp = ct.GaussianProcess(model(), t, yerr=0.25, mean=0.1)
            torch.cuda.synchronize()
            compute_s = time.perf_counter() - start
            assert all(x.is_cuda for x in gp.state), "the state is not on the card"
            got = gp_calls(gp, gp.state.t.new_tensor(y), t_new, t_var, seed=3)
        launches[label] = dict(_build.LAUNCHES)
        assert not any(plain_calls.values()), plain_calls
        # compute 1 factor; log_likelihood 1 sweep, apply_inverse 2,
        # predict 2 + 2 + (2 + 2), sample 1; each predict at new points
        # two rectangular products (its mean) of 3 prefix launches each
        assert launches[label]["factor_fwd"] == 1, launches[label]
        assert launches[label]["sweep_fwd"] == 12, launches[label]
        assert launches[label]["affine_prefix"] == 12, launches[label]

        log("gp_path", f"{label}, N = 1e5, float64 | {smi}")
        log("gp_path", f"{label}: compute {1e3 * compute_s:.2f} ms; state d, W "
            f"vs the CPU route: {scaled_err(gp.state.d, ref_d):.2e}, "
            f"{scaled_err(gp.state.W, ref_W):.2e}")
        assert scaled_err(gp.state.d, ref_d) < 1e-9
        assert scaled_err(gp.state.W, ref_W) < 1e-9
        shapes = {"log_likelihood": (), "apply_inverse": (N_MAIN,),
                  "predict(y)": (N_MAIN,), "predict(y, t_new) M=1e4": (10_000,),
                  "predict(y, t_new, return_var) M=500": (2, 500),
                  "sample(size=4)": (4, N_MAIN)}
        for name, (res, seconds) in got.items():
            err = scaled_err(res, ref[name][0])
            log("gp_path", f"{label}: {name}: {1e3 * seconds:.2f} ms on the card "
                f"({ref[name][1]:.1f} s on the CPU's plain route), relative "
                f"error {err:.2e}")
            assert res.is_cuda and tuple(res.shape) == shapes[name], name
            assert torch.isfinite(res).all() and err < 1e-9, (label, name, err)
        var = got["predict(y, t_new, return_var) M=500"][0][1]
        assert (var > 0).all(), "a predictive variance is not positive"
        log("gp_path", f"{label}: launches {launches[label]}; plain versions "
            f"called on the path: {plain_calls}")

    # J = 4: the general route's log-likelihood against the fused path (K1)
    gp = ct.GaussianProcess(GP_MODELS["J=4"](), t, yerr=0.25, mean=0.1)
    with torch.no_grad():
        fused = ct.gp_loglik(GP_MODELS["J=4"](), t, y, yerr=0.25, mean=0.1)
    err = scaled_err(gp.log_likelihood(y), fused)
    log("gp_path", f"J=4: gp.log_likelihood vs gp_loglik (fused path): {err:.2e}")
    assert err < 1e-9

    # a system that is not positive definite
    try:
        ct.GaussianProcess(wide_kernel(8, 1.0), t[:2000], diag=-5.0)
    except ct.LinAlgError:
        quiet = ct.GaussianProcess(wide_kernel(8, 1.0))
        quiet.compute(t[:2000], diag=-5.0, quiet=True)
        ll = quiet.log_likelihood(y[:2000]).item()
        log("gp_path", f"non-PD J = 8: compute raises LinAlgError; quiet ll = {ll}")
        assert ll == -math.inf
    else:
        raise AssertionError("a non-PD system did not raise LinAlgError")

    # a dense yardstick at a size where it fits: torch.linalg.cholesky +
    # cholesky_solve on the dense matrix (used nowhere in the package)
    n = 4000
    small = ct.GaussianProcess(wide_kernel(8, 1.0), t[:n], yerr=0.25)
    ys = small.state.t.new_tensor(y[:n])
    K = small.kernel.to_dense(small.state.t, small.state.diag)
    dense = torch.cholesky_solve(ys[:, None], torch.linalg.cholesky(K))[:, 0]
    err = scaled_err(small.apply_inverse(ys), dense)
    ms = cuda_ms(lambda: small.apply_inverse(ys), reps=5)
    ms_dense = cuda_ms(lambda: torch.cholesky_solve(
        ys[:, None], torch.linalg.cholesky(K)), reps=5)
    log("gp_path", f"apply_inverse at N = {n}, J = 8: {ms:.3f} ms; dense "
        f"cholesky + cholesky_solve of the same matrix: {ms_dense:.3f} ms "
        f"(relative difference {err:.2e})")
    assert err < 1e-8
    return launches["J=8"]


# ------------------------------------------------ the training path, J = 8

TRAIN_KERNELS = ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd")


def phase_train_j8(dev, smi, refs):
    """gp_loglik value and theta-gradient for the J = 8 model (wide8) at
    N = 1e5, float64, one chain, through factor_fwd and sweep_fwd with their
    caches and the adjoint kernels sweep_bwd and factor_bwd, against the
    CPU's plain route (value 1e-9 relative, gradient 1e-8 scaled); 64
    chains at N = 3e4 against a loop over the chains, and 1024 chains
    timed; the gradient of GaussianProcess.log_likelihood against the same CPU reference; and a
    dense yardstick at N = 4000."""
    v, g, seconds = refs.get()["train"]
    ref = torch.from_numpy(v), torch.from_numpy(g)
    log("train J=8", f"CPU plain route: {seconds:.1f} s")
    td, yd = bench_data(N_MAIN, dev, torch.float64)
    thd = torch.tensor(THETA0, device=dev)
    value_and_grad(thd, td, yd, wide8)  # warm-up
    reset_launches()
    with count_plain_versions() as plain_calls:
        torch.cuda.synchronize()
        start = time.perf_counter()
        got = value_and_grad(thd, td, yd, wide8)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
    launches = dict(_build.LAUNCHES)
    assert not any(plain_calls.values()), plain_calls
    log("train J=8", f"N = 1e5, float64, C = 1 | {smi}")
    _check_path("train J=8", {"gp_loglik": got}, {"gp_loglik": ref},
                {"gp_loglik": (1e-9, 1e-8)}, 3)
    log("train J=8", f"one value+gradient eval {1e3 * eval_s:.2f} ms; launches "
        f"{launches}")
    for name in TRAIN_KERNELS:
        assert launches[name] == 1, f"{name}: {launches[name]} launches per eval"

    # the same gradient through the state API: compute, log_likelihood
    thg = thd.clone().requires_grad_(True)
    before = dict(_build.LAUNCHES)
    gp = ct.GaussianProcess(wide8(thg), td, yerr=0.25)
    ll = gp.log_likelihood(yd)
    (g,) = torch.autograd.grad(ll, thg)
    ev, eg = scaled_err(ll, ref[0]), scaled_err(g, ref[1])
    log("train J=8", f"GaussianProcess(...).log_likelihood(y) gradient vs the CPU "
        f"gp_loglik reference: value err {ev:.2e}, grad err {eg:.2e}")
    assert ev < 1e-9 and eg < 1e-8, (ev, eg)
    for name in TRAIN_KERNELS:
        assert _build.LAUNCHES[name] == before[name] + 1, name

    # 64 chains at N = 3e4 against a loop over the chains
    C, N = 64, 30_000
    rng = np.random.default_rng(17)
    t3, y3 = bench_data(N, dev, torch.float64, seed=8)
    thetas = torch.tensor(THETA0 + 0.1 * rng.normal(size=(C, 3)), device=dev)
    v, g = value_and_grad(thetas, t3, y3, wide8)
    assert v.shape == (C,) and g.shape == (C, 3)
    loop = [value_and_grad(thetas[k], t3, y3, wide8) for k in range(C)]
    ev = scaled_err(v, torch.stack([x[0] for x in loop]))
    eg = max(scaled_err(g[k], loop[k][1]) for k in range(C))
    log("train J=8", f"C = {C}, N = {N}: batched vs loop value err {ev:.2e}, "
        f"grad err {eg:.2e}")
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    assert ev < 1e-10 and eg < 1e-10, (ev, eg)
    # a fleet of 1024 chains (the sampler's) at the same N, timed
    thetas = torch.tensor(THETA0 + 0.1 * rng.normal(size=(1024, 3)), device=dev)
    v, g = value_and_grad(thetas, t3, y3, wide8)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    ms = cuda_ms(lambda: value_and_grad(thetas, t3, y3, wide8), reps=3, warmup=1)
    log("train J=8", f"C = 1024, N = {N}: value+gradient eval {ms:.2f} ms, "
        f"{1e3 / ms:.2f} evals/s, float64 | {smi}")

    # a yardstick: the gradient through the dense Cholesky factor at N = 4000
    # (torch.linalg.cholesky; used nowhere in the package)
    ts, ys = td[:4000], yd[:4000]
    n = len(ts)

    def dense_value_and_grad():
        th = thd.detach().requires_grad_(True)
        K = wide8(th).to_dense(ts, torch.full_like(ts, 0.0625))
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(ys[:, None], L)[:, 0]
        ll = -0.5 * (2 * torch.log(torch.diagonal(L)).sum() + ys @ alpha
                     + n * math.log(2 * math.pi))
        (g,) = torch.autograd.grad(ll, th)
        return ll.detach(), g

    dense = dense_value_and_grad()
    port = value_and_grad(thd, ts, ys, wide8)
    ev, eg = scaled_err(port[0], dense[0]), scaled_err(port[1], dense[1])
    ms = cuda_ms(lambda: value_and_grad(thd, ts, ys, wide8), reps=5)
    ms_dense = cuda_ms(dense_value_and_grad, reps=3)
    log("train J=8", f"value+gradient at N = {n}: {ms:.3f} ms; through the dense "
        f"Cholesky factor {ms_dense:.3f} ms (difference: value {ev:.2e}, grad "
        f"{eg:.2e})")
    assert ev < 1e-9 and eg < 1e-6, (ev, eg)
    return launches


# ------------------------------------------------------- the assoc tier


@contextmanager
def tier(name):
    """Run with ``set_config(backend=name)``, restored after."""
    prior = ct.get_config()
    ct.set_config(backend=name)
    try:
        yield
    finally:
        ct.set_config(**prior.__dict__)


def prefix_inputs(J, N, C, K, dev, seed):
    """``(p, a, U, V, Y)`` of ``wide_system``: the row data the Riccati and
    Kalman prefixes build their elements from."""
    t, c, a, U, V, Y = wide_system(J, N, C, K, dev, seed=seed)
    return scan.transport(t, c), a, U, V, Y


def frev_maps(J, M, C, dev, seed):
    """``M`` per-step maps of the factor adjoint on the J^2 entries of its
    carry (``assoc.frev_step_maps``, the dense form of phase B), with random
    cotangents."""
    rng = np.random.default_rng(seed)
    p, a, U, V, _ = prefix_inputs(J, M + 1, C, 1, dev, seed)
    d, W, _ = _build.factor_fwd_cuda(p, a, U, V)
    bv0, bdp = randn_like(W, rng)[:, 1:], randn_like(d, rng)[:, 1:]
    return assoc.frev_step_maps(p[:, 1:], U[:, 1:], W[:, 1:], bv0, bdp)


def sequential_prefix(name, inputs, reverse=False):
    """The prefix of a family row by row, the sequential recursion the
    doubling reorganises: the factor and lower solve's plain loop
    (``scan.factor_solve_plain``) for the Riccati and Kalman families (S
    after every row is its cache S_half times diag(p), F its cache F times
    diag(p)), ``x <- A x + b`` over the rows for the matrix-affine one."""
    if name == "mat_affine_prefix":
        A, b = inputs
        x, rows = torch.zeros_like(b[:, 0]), [None] * b.shape[1]
        for m in range(b.shape[1] - 1, -1, -1) if reverse else range(b.shape[1]):
            x = A[:, m] @ x + b[:, m]
            rows[m] = x
        return (torch.stack(rows, 1),)
    p, a, U, V = inputs[:4]
    Y = inputs[4] if len(inputs) > 4 else torch.zeros_like(a)[..., None]
    _, _, _, S_half, F = scan.factor_solve_plain(p, a, U, V, Y)
    S = S_half * p[..., None, :]
    return (S,) if len(inputs) == 4 else (S, p[..., :, None] * F)


def hold_prefix(checks, worst, tol=1e-10):
    """``checks``: (name, kernel outputs, doubling outputs, row-by-row
    outputs).  Each kernel output is held to ``tol`` relative against the
    row-by-row recursion, and against the plain doubling to ``tol`` or 1.5
    times the doubling's own distance from the row-by-row recursion,
    whichever is larger (the doubling composes maps of up to N / 2 rows and
    loses more digits than the row recursion the kernel's apply walk runs).
    ``worst[name]`` keeps (against the rows, against the doubling, the
    doubling's own)."""
    for name, got, dbl, rows in checks:
        for g, d, r in zip(got, dbl, rows):
            assert g.shape == d.shape == r.shape, (name, tuple(g.shape))
            e_rows, e_dbl, e_self = scaled_err(g, r), scaled_err(g, d), scaled_err(d, r)
            tol_dbl = max(tol, 1.5 * e_self)
            assert math.isfinite(e_rows) and e_rows < tol, (name, tuple(g.shape), e_rows)
            assert math.isfinite(e_dbl) and e_dbl < tol_dbl, (
                name, tuple(g.shape), e_dbl, tol_dbl)
            worst[name] = tuple(map(max, worst[name], (e_rows, e_dbl, e_self)))


def phase_assoc_kernels(dev):
    """riccati_prefix, kalman_prefix (K = 1, 5) and mat_affine_prefix (the
    lower solve's J x J maps, K = 1, 5, forward and reverse; the factor
    adjoint's J^2 x J^2 maps at M = 130, 1040 for J <= 8 and M = 130 at
    J = 16) on the card, float64, against their plain doublings and the
    row-by-row recursion (``hold_prefix``, 1e-10): J = 1, 2, 3 -> 4, 8, 16,
    32; N = 130, 1040, 1e4; C = 8, and C = 1 as the first of those chains.
    Then their times at N = 1e5, J = 8, K = 1, C = 1 and 64, and at C = 1
    the same checks at 1e-9."""
    worst = {name: (0.0, 0.0, 0.0) for name in ASSOC}
    first = lambda xs: [x[:1] for x in xs]  # noqa: E731
    for J in (1, 2, 3, 8, 16, 32):
        for N in (130, 1040, 10_000):
            p, a, U, V, Y5 = prefix_inputs(J, N, 8, 5, dev, seed=J + N)
            fin = (p, a, U, V)
            W = _build.factor_fwd_cuda(*fin)[1]
            # one doubling and one row loop per family at K = 5: each
            # right-hand side's leaves depend on its own column only, so
            # those at K = 1 are their first column
            Y1 = Y5[..., :1].contiguous()
            kal_dbl = pe.kalman_prefix_plain(*fin, Y5)
            kal_rows = sequential_prefix("kalman_prefix", fin + (Y5,))
            col0 = lambda xs: [xs[0], xs[1][..., :1]]  # noqa: E731
            dbl = (pe.riccati_prefix_plain(*fin),)
            checks = [
                ("riccati_prefix", (_build.riccati_prefix_cuda(*fin),), dbl,
                 kal_rows[:1]),
                ("riccati_prefix", (_build.riccati_prefix_cuda(*first_chain(fin)),),
                 first(dbl), first(kal_rows[:1])),
                ("kalman_prefix", _build.kalman_prefix_cuda(*fin, Y5), kal_dbl,
                 kal_rows),
                ("kalman_prefix", _build.kalman_prefix_cuda(*fin, Y1), col0(kal_dbl),
                 col0(kal_rows)),
                ("kalman_prefix", _build.kalman_prefix_cuda(*first_chain(fin + (Y1,))),
                 first(col0(kal_dbl)), first(col0(kal_rows))),
            ]
            A, b = assoc.solve_elements(p, U, W, Y5)
            A1, b1 = A, b[..., :1].contiguous()
            for reverse in (False, True):
                dbl = (pe.mat_affine_prefix_plain(A, b, reverse=reverse),)
                rows = sequential_prefix("mat_affine_prefix", (A, b), reverse)
                dbl1, rows1 = (dbl[0][..., :1],), (rows[0][..., :1],)
                checks += [
                    ("mat_affine_prefix",
                     (_build.mat_affine_prefix_cuda(A, b, reverse),), dbl, rows),
                    ("mat_affine_prefix",
                     (_build.mat_affine_prefix_cuda(A1, b1, reverse),), dbl1, rows1),
                    ("mat_affine_prefix", (_build.mat_affine_prefix_cuda(
                        *first_chain((A1, b1)), reverse),), first(dbl1), first(rows1)),
                ]
            hold_prefix(checks, worst)
        for M in ((130, 1040) if J <= 8 else (130,) if J == 16 else ()):
            A, b = frev_maps(J, M, 8 if J <= 8 else 1, dev, seed=J * M)
            for reverse in (False, True):
                hold_prefix([("mat_affine_prefix",
                              (_build.mat_affine_prefix_cuda(A, b, reverse),),
                              (pe.mat_affine_prefix_plain(A, b, reverse=reverse),),
                              sequential_prefix("mat_affine_prefix", (A, b), reverse))],
                            worst)
    for name, (e_rows, e_dbl, e_self) in worst.items():
        log("assoc", f"{name}: worst relative error {e_rows:.3e} against the row "
            f"recursion, {e_dbl:.3e} against the plain doubling (whose own "
            f"distance from the row recursion reaches {e_self:.3e}) (J = 1, 2, "
            "3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8 and 1" +
            ("; K = 1, 5" if name != "riccati_prefix" else "") +
            ("; forward and reverse; D = J^2 at M = 130, 1040 for J <= 8, 130 "
             "at J = 16" if name == "mat_affine_prefix" else "") + ")")

    # times at the assoc path's shapes: N = 1e5, J = 8, K = 1, float64
    main_abs, times = {}, {}
    for C in (1, 64):
        p, a, U, V, Y = prefix_inputs(8, N_MAIN, C, 1, dev, seed=8)
        fin = (p, a, U, V)
        W = _build.factor_fwd_cuda(*fin)[1]
        A, b = assoc.solve_elements(p, U, W, Y)
        runs = {
            "riccati_prefix": (lambda: (_build.riccati_prefix_cuda(*fin),),
                               lambda: (pe.riccati_prefix_plain(*fin),), fin),
            "kalman_prefix": (lambda: _build.kalman_prefix_cuda(*fin, Y),
                              lambda: pe.kalman_prefix_plain(*fin, Y), fin + (Y,)),
            "mat_affine_prefix": (lambda: (_build.mat_affine_prefix_cuda(A, b),),
                                  lambda: (pe.mat_affine_prefix_plain(A, b),),
                                  (A, b)),
        }
        if C == 1:
            # one row loop serves the Riccati and Kalman families
            _, _, _, S_half, F = scan.factor_solve_plain(*fin, Y)
            S = S_half * p[..., None, :]
            rows = {"riccati_prefix": (S,), "kalman_prefix": (S, p[..., :, None] * F),
                    "mat_affine_prefix": sequential_prefix("mat_affine_prefix", (A, b))}
        for name, (kernel, plain, inputs) in runs.items():
            before = _build.LAUNCHES[name]
            got = kernel()
            torch.cuda.synchronize()
            per_call = _build.LAUNCHES[name] - before
            ms = cuda_ms(kernel, reps=5, warmup=1)
            bound, by = bound_ms((*inputs, *got), kernel_flops(name, C, N_MAIN, 8))
            L = (_build.prefix_block_len if name == "mat_affine_prefix"
                 else _build.kalman_block_len)(N_MAIN)
            log("assoc", f"{name}: {ms:.4f} ms (bound {bound:.4f} ms by {by}; "
                f"{per_call} launches, L = {L}) at N = 1e5, J = 8, K = 1, "
                f"C = {C}, float64")
            if C == 1:
                dbl, plain_ms = timed_plain(plain)
                log("assoc", f"{name}: plain version {plain_ms:.1f} ms (one run)")
                main = {name: (0.0, 0.0, 0.0)}
                hold_prefix([(name, got, dbl, rows[name])], main, tol=LONG_RTOL)
                log("assoc", f"{name} at N = 1e5: relative error {main[name][0]:.3e} "
                    f"against the row recursion, {main[name][1]:.3e} against the "
                    f"doubling (its own distance {main[name][2]:.3e})")
                main_abs[name] = max((g - d).abs().max().item()
                                     for g, d in zip(got, dbl))
                times[name] = (ms, plain_ms, bound, by)
    # the shape of the factor adjoint's phase B at N = 1e5, J = 8, C = 1:
    # the prefix of ceil(N / L) maps of 64 x 64 (contracting random maps:
    # the adjoint's own maps are checked above, and on the path)
    NB = -(-N_MAIN // assoc.frev_block_len(1, N_MAIN, 8))
    rng = np.random.default_rng(5)
    A = torch.tensor(rng.normal(size=(1, NB, 64, 64)) / 12.0, device=dev)
    b = torch.tensor(rng.normal(size=(1, NB, 64, 1)), device=dev)
    got = _build.mat_affine_prefix_cuda(A, b)
    ms = cuda_ms(lambda: _build.mat_affine_prefix_cuda(A, b), reps=5, warmup=1)
    main = {"mat_affine_prefix": (0.0, 0.0, 0.0)}
    hold_prefix([("mat_affine_prefix", (got,), (pe.mat_affine_prefix_plain(A, b),),
                  sequential_prefix("mat_affine_prefix", (A, b)))], main)
    log("assoc", f"mat_affine_prefix at phase B's shape (M = {NB} maps of 64 x 64, "
        f"K = 1, C = 1): {ms:.4f} ms, relative errors {main}")
    return main_abs, times


def general_value_and_grad(theta, t, y, model):
    """The log-likelihood and its theta-gradient through ``ops.factor_solve``
    and its adjoint: what ``gp_loglik`` runs above J = 4, at any J (at
    J <= 4 gp_loglik runs the fused path instead)."""
    theta = theta.detach().requires_grad_(True)
    c, a, U, V = model(theta).get_celerite_matrices(t, torch.full_like(t, 0.0625))
    if c.dim() == 2:
        C, N = c.shape[0], t.shape[-1]
        t, y = t.expand(C, N), y.expand(C, N)
        a, U, V = a.expand(C, N), U.expand(C, N, -1), V.expand(C, N, -1)
    d, _, z = ct.ops.factor_solve(t, c, a, U, V, y[..., None])
    ll = -0.5 * (torch.log(d).sum(-1) + (z[..., 0] ** 2 / d).sum(-1)
                 + t.shape[-1] * math.log(2 * math.pi))
    (g,) = torch.autograd.grad(ll.sum(), theta)
    return ll.detach(), g


def phase_assoc_path(dev, smi, refs):
    """The J = 8 path with backend="assoc" at N = 1e5, float64, one chain:
    GaussianProcess compute, log_likelihood, apply_inverse, predict(y)
    against the CPU references of the GP phase, and gp_loglik's value and
    theta-gradient against the training phase's: each to 1e-9 (the
    gradient 1e-8 scaled), or to 1.5 times the error of the CPU's plain
    assoc route against the same reference if that is larger; launches per
    call; non-PD; 8 chains against a loop; float32."""
    t, y, _, _ = gp_data(N_MAIN)
    ref_d, ref_W, ref = refs.get()["J=8"]
    cpu_d, cpu_W, cpu_calls = refs.get()["J=8 assoc"]
    v_ref, g_ref, _ = refs.get()["train"]
    v_cpu, g_cpu, cpu_s = refs.get()["train assoc"]
    err_cpu_v = scaled_err(torch.from_numpy(v_cpu), torch.from_numpy(v_ref))
    err_cpu_g = scaled_err(torch.from_numpy(g_cpu), torch.from_numpy(g_ref))
    tol_v, tol_g = max(1e-9, 1.5 * err_cpu_v), max(1e-8, 1.5 * err_cpu_g)
    log("assoc path", f"the CPU's plain assoc route against its scan route at "
        f"N = 1e5, J = 8: value {err_cpu_v:.2e}, gradient {err_cpu_g:.2e} "
        f"({cpu_s:.1f} s); gates value {tol_v:.3g}, gradient {tol_g:.3g}")
    per_call = {}

    def run(name, fn):
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        per_call[name] = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                          if v != before[k]}
        log("assoc path", f"{name}: {1e3 * seconds:.2f} ms, launches "
            f"{per_call[name]}")
        return out

    td, yd = bench_data(N_MAIN, dev, torch.float64)
    thd = torch.tensor(THETA0, device=dev)
    with tier("assoc"):
        # warm-up of every call (the first launch of a kernel loads it)
        gp = ct.GaussianProcess(GP_MODELS["J=8"](), t[:5000], yerr=0.25)
        gp.predict(gp.state.t.new_tensor(y[:5000]))
        value_and_grad(thd, td[:5000], yd[:5000], wide8)
        reset_launches()
        with count_plain_versions() as plain_calls:
            gp = run("compute", lambda: ct.GaussianProcess(
                GP_MODELS["J=8"](), t, yerr=0.25, mean=0.1))
            ys = gp.state.t.new_tensor(y)
            got = {name: run(name, fn) for name, fn in (
                ("log_likelihood", lambda: gp.log_likelihood(ys)),
                ("apply_inverse", lambda: gp.apply_inverse(ys)),
                ("predict(y)", lambda: gp.predict(ys)))}
            vg = run("gp_loglik value+grad", lambda: value_and_grad(thd, td, yd, wide8))
        launches = dict(_build.LAUNCHES)
    assert not any(plain_calls.values()), plain_calls
    log("assoc path", f"N = 1e5, J = 8, float64, C = 1 | {smi}")
    held = [("state d", gp.state.d, ref_d, cpu_d), ("state W", gp.state.W, ref_W, cpu_W)]
    held += [(name, res, ref[name][0], cpu_calls[name]) for name, res in got.items()]
    for name, res, want, cpu in held:
        want = torch.from_numpy(want)
        err, err_cpu = scaled_err(res, want), scaled_err(torch.from_numpy(cpu), want)
        tol = max(1e-9, 1.5 * err_cpu)
        log("assoc path", f"{name} vs the CPU's scan route: {err:.2e} (the CPU's "
            f"assoc route: {err_cpu:.2e}; tol {tol:.3g})")
        assert res.device.type == dev.type and torch.isfinite(res).all(), name
        assert err < tol, (name, err, tol)
    _check_path("assoc path", {"gp_loglik": vg},
                {"gp_loglik": (torch.from_numpy(v_ref), torch.from_numpy(g_ref))},
                {"gp_loglik": (tol_v, tol_g)}, 3)
    for name in ASSOC:
        assert launches[name] >= 1, f"{name} was not launched on the assoc path"
    for name in TRAIN_KERNELS:
        assert launches[name] == 0, f"the assoc path launched {name}"
    log("assoc path", f"launches over the path: {launches}")

    with tier("assoc"):
        # a system that is not positive definite
        th = torch.tensor(THETA0, device=dev).requires_grad_(True)
        ll = ct.gp_loglik(wide8(th), td[:2000], yd[:2000], diag=-5.0)
        (g,) = torch.autograd.grad(ll, th)
        log("assoc path", f"non-PD wide8: ll = {ll.item()}, grad = {g.tolist()}")
        assert ll.item() == -math.inf and torch.all(g == 0)
        # 8 chains at N = 3e4 against a loop over the chains
        C, N = 8, 30_000
        rng = np.random.default_rng(17)
        t3, y3 = bench_data(N, dev, torch.float64, seed=8)
        thetas = torch.tensor(THETA0 + 0.1 * rng.normal(size=(C, 3)), device=dev)
        v, g = value_and_grad(thetas, t3, y3, wide8)
        loop = [value_and_grad(thetas[k], t3, y3, wide8) for k in range(C)]
        ev = scaled_err(v, torch.stack([x[0] for x in loop]))
        eg = max(scaled_err(g[k], loop[k][1]) for k in range(C))
        log("assoc path", f"C = {C}, N = {N}: batched vs loop value err {ev:.2e}, "
            f"grad err {eg:.2e}")
        assert ev < 1e-10 and eg < 1e-10, (ev, eg)
        # float32 at N = 1e5 against the float64 reference
        t32, y32 = bench_data(N_MAIN, dev, torch.float32)
        v32, g32 = value_and_grad(thd.float(), t32, y32, wide8)
        ev = scaled_err(v32, torch.from_numpy(v_ref))
        eg = scaled_err(g32, torch.from_numpy(g_ref))
        ok32 = bool(torch.isfinite(v32).all()) and ev < F32_RTOL
        log("assoc path", f"float32, N = 1e5, J = 8: value err {ev:.2e}, grad err "
            f"{eg:.2e} against the float64 reference: the value "
            f"{'passes' if ok32 else 'fails'} the float32 gate {F32_RTOL:g}")
    if not ok32:
        assert (torch.float32, 8, False) not in dispatch.ASSOC_MIN_ROWS, (
            "auto sends float32 at J = 8 to the assoc tier, which fails its gate")
    return launches, ok32


CROSS_MODELS = {2: (sho, THETA0), 4: (sho_mixture, THETA4), 8: (wide8, THETA0)}


def phase_crossover(dev, ok32):
    """factor, solve_lower (both under no_grad, as the serving path calls
    them) and the log-likelihood's value and theta-gradient through
    ops.factor_solve, on each tier, with CUDA events (1 warm-up, 3 runs):
    J = 2, 4, 8; N = 1e3, 1e4, 1e5; C = 1, 64; float64, and float32 at J = 8.
    Prints the table and the rule it supports for dispatch.ASSOC_MIN_ROWS:
    the fewest rows from which the assoc tier is faster in all three and as
    accurate as the gates ask (its log-likelihood and gradient against the
    float64 scan tier's), and float32 only if its value passed the float32
    gate on the path (``ok32``)."""
    Ns = (1_000, 10_000, N_MAIN)
    faster, rows = {}, []
    configs = [(torch.float64, J) for J in (2, 4, 8)] + [(torch.float32, 8)]
    for dtype, J in configs:
        model, theta0 = CROSS_MODELS[J]
        for C in (1, 64):
            for N_rows in Ns:
                t, y = bench_data(N_rows, dev, dtype)
                N = t.shape[-1]
                theta = torch.tensor(theta0, device=dev, dtype=dtype)
                if C > 1:
                    noise = np.random.default_rng(17).normal(size=(C, len(theta0)))
                    theta = theta + 0.1 * torch.tensor(noise, device=dev, dtype=dtype)
                with torch.no_grad():
                    c, a, U, V = model(theta).get_celerite_matrices(
                        t, torch.full_like(t, 0.0625))
                    tc = t.expand(C, N) if C > 1 else t
                    if C > 1:
                        a, U, V = a.expand(C, N), U.expand(C, N, -1), V.expand(C, N, -1)
                    Y = (y.expand(C, N) if C > 1 else y)[..., None]
                    W = ct.ops.factor(tc, c, a, U, V)[1]
                ms, out = {}, {}
                for name in ("scan", "assoc"):
                    with tier(name), torch.no_grad():
                        ms[name, "factor"] = cuda_ms(
                            lambda: ct.ops.factor(tc, c, a, U, V), reps=3, warmup=1)
                        ms[name, "solve_lower"] = cuda_ms(
                            lambda: ct.ops.solve_lower(tc, c, U, W, Y), reps=3, warmup=1)
                    with tier(name):
                        out[name] = general_value_and_grad(theta, t, y, model)
                        ms[name, "loglik+grad"] = cuda_ms(
                            lambda: general_value_and_grad(theta, t, y, model),
                            reps=3, warmup=1)
                # accuracy: each tier against the float64 scan tier; the
                # assoc tier within 1e-9 (value) and 1e-8 (gradient), or in
                # float32 within 1e-3 or 1.5 times the scan tier's own error
                with tier("scan"):
                    ref = out["scan"] if dtype == torch.float64 else \
                        general_value_and_grad(theta.double(), t.double(),
                                               y.double(), model)
                errs = {name: (scaled_err(v, ref[0]), scaled_err(g, ref[1]))
                        for name, (v, g) in out.items()}
                if dtype == torch.float64:
                    tols = (1e-9, 1e-8)
                else:
                    tols = tuple(max(F32_RTOL, 1.5 * e) for e in errs["scan"])
                accurate = all(math.isfinite(e) and e < tol
                               for e, tol in zip(errs["assoc"], tols))
                wins = all(ms["assoc", op] < ms["scan", op]
                           for op in ("factor", "solve_lower", "loglik+grad"))
                faster[dtype, J, C > 1, N_rows] = wins and accurate
                rows.append(f"{str(dtype)[6:]} J={J} C={C} N={N}: " + ", ".join(
                    f"{op} scan {ms['scan', op]:.3f} / assoc {ms['assoc', op]:.3f} ms"
                    for op in ("factor", "solve_lower", "loglik+grad"))
                    + f"; assoc value err {errs['assoc'][0]:.2e}, grad err "
                    f"{errs['assoc'][1]:.2e} (tol {tols[0]:.3g}, {tols[1]:.3g})")
                log("crossover", rows[-1])
    rule = {}
    for dtype, J in configs if ok32 else configs[:-1]:
        for many in (False, True):
            for N in Ns:
                if all(faster[dtype, J, many, n] for n in Ns if n >= N):
                    rule[dtype, J, many] = N
                    break
    log("crossover", f"the rule this run supports: {rule}")
    log("crossover", f"dispatch.ASSOC_MIN_ROWS: {dispatch.ASSOC_MIN_ROWS}"
        f" ({'the same' if rule == dispatch.ASSOC_MIN_ROWS else 'differs'})")


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
    """A system that is not positive definite: -inf and zero gradients at
    J = 2, 4 (the fused path) and 8 (factor_solve and its adjoints)."""
    t, y = bench_data(2000, dev, torch.float64)
    for model, theta0 in ((sho, THETA0), (sho_mixture, THETA4), (wide8, THETA0)):
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
            plain = steps_per_s(dev, dtype, n_steps=3)
        log("steps", f"J = 2, {dtype}: kernel route {kernel:.2f} evals/s "
            f"(20 chained steps), plain route {plain:.3f} evals/s (3 steps); "
            f"N = 1e5, SHOTerm, L = {L}")
    for dtype in (torch.float64, torch.float32):
        kernel = steps_per_s(dev, dtype, model=sho_mixture, theta0=THETA4)
        with plain_route():
            plain = steps_per_s(dev, dtype, n_steps=3, model=sho_mixture,
                                theta0=THETA4)
        log("steps", f"J = 4, {dtype}: kernel route {kernel:.2f} evals/s "
            f"(20 chained steps), plain route {plain:.3f} evals/s (3 steps); "
            f"N = 1e5, config5 SHO mixture, L = {L}")
    # J = 8: the general factor and lower solve with their adjoints, one
    # chain at N = 1e5 and 64 chains at N = 3e4
    for dtype in (torch.float64, torch.float32):
        rate = steps_per_s(dev, dtype, model=wide8)
        log("steps", f"J = 8, {dtype}: {rate:.2f} evals/s (20 chained steps); "
            "N = 1e5, C = 1, four SHOTerms")
    C, N = 64, 30_000
    theta0 = THETA0 + 0.1 * np.random.default_rng(17).normal(size=(C, 3))
    rate = steps_per_s(dev, torch.float64, model=wide8, theta0=theta0,
                       data=bench_data(N, dev, torch.float64, seed=8))
    log("steps", f"J = 8, torch.float64, C = {C}, N = {N}: {rate:.2f} evals/s "
        f"(20 chained steps), {C * rate:.1f} chain-evals/s")
    # config5's own size: t ~ sort(U(0, 1e4)), N = 1e6, seed 11
    N = 1_000_000
    data = bench_data(N, dev, torch.float64, seed=11, span=10_000.0)
    torch.cuda.reset_peak_memory_stats()
    rate = steps_per_s(dev, torch.float64, n_steps=5, model=sho_mixture,
                       theta0=THETA4, data=data)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("steps", f"J = 4, torch.float64, N = 1e6 (config5 J4): kernel route "
        f"{rate:.2f} evals/s (5 chained steps, L = "
        f"{fl.default_block_len(N)}), peak device memory {peak:.2f} GiB")


def phase_profile(dev, label, model, theta0):
    """torch.profiler over 3 value+gradient evaluations at N = 1e5,
    float64: device kernels per evaluation, device busy time, idle share
    and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t, y = bench_data(N_MAIN, dev, torch.float64)
    theta = torch.tensor(theta0, device=dev)
    value_and_grad(theta, t, y, model)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            value_and_grad(theta, t, y, model)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile", "no device events in the trace: not measured")
        return
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / n
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / n
    log("profile", f"{label}, N = 1e5, float64: {len(kernels) / n:.0f} device "
        f"kernels per eval, device busy {busy / 1000:.3f} ms of a "
        f"{span / 1000:.3f} ms span per eval (idle share "
        f"{1 - busy / span:.3f}; under the profiler)")
    ours = (*KERNELS, *GENERAL)
    by_name = {}
    for e in kernels:
        name = next((k for k in ours if f"{k}_kernel" in e.name), e.name[:60])
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log("profile", f"{label}: per eval, device time by kernel (top 8): " + "; ".join(
        f"{k} x{c / n:.0f} {us / n / 1000:.4f} ms" for k, (c, us) in top))
    log("profile", f"{label}: per eval, this repo's kernels: " + ", ".join(
        f"{k} {by_name[k][1] / n / 1000:.4f} ms" for k in ours if k in by_name))


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

    def timed(phase, *args):
        began = time.perf_counter()
        out = phase(*args)
        log("time", f"{phase.__name__}: {time.perf_counter() - began:.1f} s")
        return out

    smi = phase_device()
    # every phase but the assoc tier's runs the sequential tier
    ct.set_config(backend="scan")
    refs = CpuReferences(N_MAIN)
    try:
        timed(phase_build)
        main_abs, times = timed(phase_kernels, dev)
        for phase in (phase_general_kernels, phase_prefix_kernel,
                      phase_adjoint_kernels):
            phase_abs, phase_times = timed(phase, dev)
            main_abs.update(phase_abs)
            times.update(phase_times)
        launches = timed(phase_main_path, dev)
        launches4 = timed(phase_main_path_j4, dev)
        launches8 = timed(phase_gp_path, dev, smi, refs)
        launches_train = timed(phase_train_j8, dev, smi, refs)
        phase_abs, phase_times = timed(phase_assoc_kernels, dev)
        main_abs.update(phase_abs)
        times.update(phase_times)
        launches_assoc, ok32 = timed(phase_assoc_path, dev, smi, refs)
    finally:
        refs.stop()
    timed(phase_crossover, dev, ok32)
    timed(phase_chains, dev)
    timed(phase_quiet_failure, dev)
    timed(phase_steps, dev)
    timed(phase_profile, dev, "J = 4", sho_mixture, THETA4)
    timed(phase_profile, dev, "J = 8", wide8, THETA0)
    if args.sweep:
        timed(phase_sweep, dev)
    log("done", f"{time.perf_counter() - start:.1f} s")
    # each kernel's launches on the path that runs it: K3 on the J = 2
    # path, K1, K2, K4, K5 on the J = 4 path, the general forward kernels on
    # the GP path, their adjoints on the training path, the prefix kernels
    # of the assoc tier on its J = 8 path
    on_path = {name: (launches if REPORT_J[name] == 2 else launches4)
               for name in KERNELS}
    on_path.update(factor_fwd=launches8, sweep_fwd=launches8,
                   affine_prefix=launches8, factor_bwd=launches_train,
                   sweep_bwd=launches_train)
    on_path.update(dict.fromkeys(ASSOC, launches_assoc))
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": TPU_KERNEL[name], "launches": on_path[name][name],
         "max_abs_err": main_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None}
        for name in on_path
    ]
    for k in kernels:
        assert k["launches"] >= 1, f"{k['name']} was not launched on its path"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
