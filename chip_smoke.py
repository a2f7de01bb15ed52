"""Smoke test of celerite2_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``celerite2_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the three main
paths through them and checks each against the plain route on the CPU in
float64:

* J = 2: the value and theta-gradient of ``gp_loglik`` for a SHOTerm at
  N = 100,000 (kernels K1, K2 and the factor adjoint K3);
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
  its bound (at J = 2, 4 and 8, 1 and 64 chains), the J = 4
  ``GaussianProcess`` path under ``backend="auto"`` (the route a user
  gets, through ``riccati_prefix`` and ``mat_affine_prefix``) beside
  ``backend="scan"``, and the crossover between the two tiers that sets
  "auto".

Every phase before the assoc phase pins ``backend="scan"``, the sequential
tier its launch counts and times assume.

It then times chained sampler steps on the J = 2, 4 and 8 paths, config5's
J = 4 model at its own size N = 1e6, and profiles the J = 2, 4 and 8
paths.  It drives the fleet sampler (``inference.run_hmc``) on
benchmarks/configs.py config3's posterior (J = 4, N = 30,000): a segment
of iterations against the CPU's plain route, 64 chains with checkpoints
and their bitwise resume, 1024 chains, and a profile of two iterations.
Then NUTS (``inference.run_nuts``): five transitions of config2's
posterior against the CPU's plain route, configs 2 and 4 after their MAP
(a checkpoint's bitwise resume), config3's posterior as a fleet of 64
chains beside ``run_hmc``, and a profile of two transitions; and
``gp_loglik`` through products and a convolution of terms.  Last, the
posterior-predictive draws under ``backend="auto"``: ``sample_pathwise`` at
N = 100,000 with 10,000 targets for the J = 4 and J = 8 models against the
CPU route, the exact law of a component conditional through the Jacobian
of its draws, ``gp_sample_conditional`` over a fleet of 64 posterior states
against its chains' one-system calls, and the adapters (``CeleriteNormal``,
the pymc cores).  Then the sharded paths (``celerite2_torch.parallel``):
the K6 modes a shard runs (the prefixes from an incoming state, the total
maps) against their plain versions, and four gloo ranks spawned on the one
card (time-sharing it) running the sequence-sharded log-likelihood, ops,
predictions and pathwise sampler, the (chains, seq) train step and
``run_hmc`` over a chain group, each against the single-rank call.  Then the
samplers over groups on benchmarks/configs.py config4's posterior (J = 4,
N = 400): ``run_smc`` at its 2048 particles and ``run_advi`` on the card
(one SMC stage and the first ADVI steps against the CPU's plain route on
numpy draws), and two gloo ranks on the card running ``run_nuts`` over a
chain group (against the one-process config4 run of the NUTS phase) and
``run_smc`` over a particle group (against the one-process card run).
Last, the native CPU driver (``celerite2_torch.cpu``), built with g++ on
the host, against the card's ``GaussianProcess`` at N = 100,000, and the
layout probe (``celerite2_torch.probes.transpose``): its kernels K15 and K16,
float32, exactly against their plain versions, timed beside PyTorch's
transpose and a copy, and the probe's path at N = 100,000.  The plain
references of the CPU run in worker processes started at launch.  K1 to
K5 are also held at the edges of their blocks and tiles and
in float32, K1 on rows that are not positive definite; K4 and K5 are timed
at J = 3, 4, N = 1e5 and 1e6, 1 and 64 chains, in both types.  Run from
the root of the repository:

    python3 chip_smoke.py            # the smoke test (a few minutes)
    python3 chip_smoke.py --sweep    # also time the fused kernels, evals/s and the
                                     # assoc tier's prefixes per block length

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a CUDA device the script
exits with status 1 and prints no result.
"""

import argparse
import itertools
import json
import math
import multiprocessing
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch

import celerite2_torch as ct
from celerite2_torch.ops import _build
from celerite2_torch.ops import assoc
from celerite2_torch.ops import dispatch
from celerite2_torch.ops import elements as el
from celerite2_torch.ops import fused_loglik as fl
from celerite2_torch.ops import layout
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan
from celerite2_torch.inference import (CheckpointManager, fit_map, run_hmc, run_nuts,
                                       summary)
from celerite2_torch.inference import adapt, chunked, run_advi, run_smc
from celerite2_torch.inference import hmc, nuts, sampler, smc
from celerite2_torch.inference.checkpoint import to_host
from celerite2_torch.probes import transpose as layout_probe
from celerite2_torch.utils.observe import sampling_monitor

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
SOURCE.update(dict.fromkeys(ASSOC + ("affine_prefix", "riccati_total", "mat_affine_total"),
                            "celerite2_torch/csrc/assoc_prefix.cu"))
# Peak rates of one H100 SXM for the bound of each kernel: 3.35 TB/s of
# device memory; 67 TFLOP/s in float32 outside the tensor cores, and half
# of that in float64 (NVIDIA's data sheet: 34 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# the width at which each kernel is timed and reported: J = 4 (config5's
# SHO mixture), except the dense factor adjoint K3, which serves J <= 2
REPORT_J = {"kalman_fwd": 4, "solve_rev": 4, "factor_rev": 2,
            "frev_maps": 4, "frev_states": 4}
# The fused kernels take their rows per block on the card themselves: K1
# and K2 _build.fused_block_len, K3 _build.factor_adjoint_block_len, K4 with
# K5 (whose input is K4's suffixes and group maps)
# _build.structured_block_len.  Their plain versions take the plain route's
# L, or for K4 and K5 the card's.
K12 = ("kalman_fwd", "solve_rev")
CARD_BLOCKS = ("frev_maps", "frev_states")
# the device kernels of one value+gradient evaluation at N = 1e5, float64,
# under torch.profiler, before K4 composed the groups' maps itself (PERF.md,
# fused_turns.py), and the fall each must show now: K5's pass over K4's
# block maps is gone from the J = 4 path
PARENT_KERNELS_PER_EVAL = {"J = 2": 400, "J = 4": 575}
KERNELS_FALL = {"J = 2": 0, "J = 4": 1}
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


def kernel_call(name, inputs, rows=None):
    """Launch the fused kernel ``name`` on ``inputs`` in blocks of ``rows``
    rows, by default of its own length on the card."""
    return KERNELS[name][1](*inputs, rows)


def plain_len(name, N, C=1):
    """The rows per block of the plain version of the fused kernel
    ``name`` held against the kernel at its own length on the card."""
    return card_len(name, N, C) if name in CARD_BLOCKS else fl.default_block_len(N)


def card_len(name, N, C=1):
    """The rows per block of the fused kernel ``name`` on the card."""
    if name in K12:
        return _build.fused_block_len(N)
    if name in CARD_BLOCKS:
        return _build.structured_block_len(N, C)
    return _build.factor_adjoint_block_len(N)


def bound_ms(arrays, flops):
    """The least time the card could take: each input read once and each
    output written once at the peak memory rate, or ``flops`` operations
    at the peak rate of the arrays' type, whichever is larger.  Returns
    ``(milliseconds, "bytes" or "operations")``."""
    nbytes = sum(x.numel() * x.element_size() for x in arrays)
    return bytes_or_ops(nbytes, flops, arrays[0].dtype)


def bytes_or_ops(nbytes, flops, dtype):
    """:func:`bound_ms` from a count of bytes and of operations."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_flops(name, C, N, J, K=1, L=None):
    """Operations of one call (of the fused kernels' three launches),
    counted from the recursions: per row, K1's rank-one composition into its
    block's map and its rank-one state step, and K2's the same for the
    affine maps, plus per block of ``_build.fused_block_len`` rows two
    combines of whole maps (the scan over the blocks and the distribute);
    per row one structured step on J^2 + 1 states and on one (K3), on
    J^2 + 1 (K4) or on one (K5), plus per block of
    ``card_len`` rows K3's six D-affine combines
    (D = J^2: the warp scan, the scan over the groups) and one map applied,
    K4's mat-vec of each of the D + 1 columns of its group's running map,
    K5's one map applied (and per group of 32 blocks, its scan over the
    groups, one more); the rank-one
    update, transport and product of the factor, the transport, projection
    and feed of a sweep, one multiply-add of the affine prefix; for the
    adjoints, the factor's rank-one update, the reads of bS's row and
    column, its transport and the deferrals, and the sweep's projection,
    feed and three sums per right-hand side.  The assoc tier's prefixes:
    per row, the rank-one composition of the block maps (A, Q, R; b, eta)
    and the row step of the apply walk (Riccati, Kalman); per row the
    composition of the row's J x J map into its block's map with the value
    from zero, and the walk again from the value entering the block
    (matrix-affine, D = J).  ``L``: the fused kernels' rows a block, by
    default the card's (:func:`card_len`)."""
    D = J * J
    L = card_len(name, N, C) if L is None else L
    NB = -(-N // L)
    blocks, groups = C * NB, C * -(-NB // _build.FUSED_GROUP)
    per_block = {"kalman_fwd": 2 * (12 * J**3 + 10 * D),
                 "solve_rev": 2 * (2 * J**3 + 2 * D),
                 "factor_rev": 6 * (2 * D**3 + 2 * D * D) + 2 * D * D,
                 "frev_maps": (D + 1) * 2 * D * D,
                 "frev_states": 2 * D * D}.get(name, 0)
    per_row = {
        "kalman_fwd": (10 * D + 15 * J + 3) + (4 * D + 11 * J + 3),
        "solve_rev": (5 * D + 5 * J) + (5 * J + 1),
        "factor_rev": (D + 2) * 10 * D,
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
    per_group = 2 * D * D if name == "frev_states" else 0
    return C * N * per_row + blocks * per_block + groups * per_group


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


# the kernels of K1 to K5 (ptxas names), which must not spill: K1 and K2
# two row kernels each and the scan over the blocks' maps; K3 its block maps
# (with K2's scan at D = J^2); K4 the block maps and their suffixes within
# each group; K5 the scan over the groups; the rows of K3 and K5; at
# J = 1..4 (K3's maps J = 1, 2) in two types
FUSED_KERNELS = ("kalman_maps", "kalman_states", "solve_maps", "solve_states",
                 "block_scan", "factor_maps", "frev_maps", "frev_scan",
                 "frev_rows")
FUSED_KERNEL_COUNT = (6 * 4 + 2 + 3 * 4) * 2
# csrc/assoc_prefix.cu's ric_{maps,carry,apply}_kernel at J = 1, 2, 4 and
# ric_{maps,groups,scan,enter,apply}_kernel at J = 8, 16, 32, two families
# and two scalar types
RIC_KERNEL_COUNT = (3 * 3 + 5 * 3) * 2 * 2


def phase_build():
    start = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - start
    log("build", f"{lib.name} ready in {seconds:.1f} s")
    name, spills, fused, ric, slab = "?", "?", [], [], {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        if line.startswith("build_seconds"):
            log("build", f"nvcc took {line.split()[1]} s")
        elif m := re.search(r"([a-z]+_[a-z]+)_kernelI([fd])(.*)", line):
            family = re.search(r"(KalmanMaps|AffineMaps)", m[3])
            width = re.search(r"Li(\d+)E", m[3])
            name = (f"{m[1]}<{'double' if m[2] == 'd' else 'float'}"
                    + (f", {family[1]}" if family else "")
                    + (f", J={width[1]}>" if width else ">"))
        elif m := re.search(r"(slab_[a-z]+)_kernelE", line):
            name = f"{m[1]}<float>"
        elif "spill stores" in line:
            spills = line.split(",")[1].strip()
            if name.split("<")[0] in FUSED_KERNELS:
                fused.append((name, spills))
            elif name.startswith("ric_"):
                ric.append((name, spills))
            elif name.startswith("slab_"):
                slab[name] = spills
        elif m := re.search(r"Used (\d+) registers", line):
            log("build", f"{name}: {m[1]} registers, {spills}")
    assert len(fused) == FUSED_KERNEL_COUNT, (
        f"K1-K5 kernels in the build log: {len(fused)}")
    spilled = [n for n, sp in fused if not sp.startswith("0 bytes")]
    assert not spilled, f"K1-K5 kernels that spill: {spilled}"
    log("build", f"K1 to K5: {len(fused)} kernels (J = 1..4, K3 J = 1, 2; "
        "float and double), 0 bytes spilled")
    assert len(ric) == RIC_KERNEL_COUNT, f"ric_* kernels in the build log: {len(ric)}"
    spilled = [n for n, sp in ric if not sp.startswith("0 bytes")]
    assert not spilled, f"Riccati and Kalman kernels that spill: {spilled}"
    log("build", f"the Riccati and Kalman prefixes: {len(ric)} kernels (three "
        "phases at J = 1, 2, 4, five at J = 8, 16, 32; both families, float "
        "and double), 0 bytes spilled")
    assert sorted(slab) == ["slab_inverse<float>", "slab_transpose<float>"], (
        f"layout kernels in the build log: {sorted(slab)}")
    assert all(sp.startswith("0 bytes") for sp in slab.values()), slab


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


# K1 to K5 at their edges (N, C, block length on the card, None for
# their own): one row, one row below and past a tile of rows and a block, a
# ragged last block, 3 and 64 chains, many groups of 32 blocks (a ragged
# last one), and 301 groups, more than the 128 threads of the scan over the
# groups, so that each thread composes a run of three (a ragged last)
K12_EDGES = ((1, 3, None), (7, 3, None), (9, 3, None), (63, 3, 64), (65, 3, 64),
             (300, 3, 32), (1000, 64, 32), (3001, 3, 8), (5000, 3, None),
             (9601, 3, 1))


def edge_calls(inputs, N, rows):
    """(name, the card route, the plain route) of K1 to K5 on the fused
    path's ``inputs`` (those of ``structured=True`` add K4's), in blocks of
    ``rows`` on the card (None: their own) and of 16 rows in the plain
    versions, K4's and K5's of the card's: K5 from K4's suffixes and group
    maps; K4 itself only with more than one block (with one it launches
    nothing and returns no maps)."""
    C = inputs["frev_maps"][0].shape[0]
    L5 = _build.structured_block_len(N, C) if rows is None else rows
    calls = [(name, lambda x, n=name: KERNELS[n][1](*x, rows),
              lambda x, n=name: KERNELS[n][0](*x, 16), name)
             for name in (*K12, "factor_rev") if name in inputs]
    if N > L5:
        calls.append(("frev_maps", lambda x: _build.frev_maps_cuda(*x, L5),
                      lambda x: fl.frev_maps_plain(*x, L5), "frev_maps"))
    calls.append(("frev_states",
                  lambda x: _build.frev_states_cuda(
                      *x, *_build.frev_maps_cuda(*x, L5), L5),
                  lambda x: fl.frev_states_plain(
                      *x, *fl.frev_maps_plain(*x, L5), L5), "frev_maps"))
    return calls


def k12_edges(dev):
    """K1, K2, K3 (J <= 2), K4 and K5 (from K4's outputs) against their plain
    versions at the edges of their blocks and tiles, in float64 (1e-10) and
    float32 (within 1e-4 or twice the plain float32 version's error, against
    the float64 plain version), and K1 on a system whose diagonal turns
    negative at row N // 3: finite states that agree with the plain
    version's up to that row and the same verdict d > 0 per chain."""
    worst = {"float64": 0.0, "float32": 0.0}
    for kind, J in KINDS[:4]:
        for N, C, rows in K12_EDGES:
            args = system(kind, N, C, dev, seed=N + J)
            inputs = fl.pass_inputs(*args)
            inputs["frev_maps"] = fl.pass_inputs(*args, structured=True)["frev_maps"]
            for name, card, plain, key in edge_calls(inputs, N, rows):
                inp = inputs[key]
                got = _tuple(card(inp))
                want = _tuple(plain(inp))
                for g, w in zip(got, want):
                    assert g.shape == w.shape, (name, kind, N, C)
                    err = scaled_err(g, w) if w.abs().max() else g.abs().max().item()
                    assert math.isfinite(err) and err < 1e-10, (name, kind, N, C, err)
                    worst["float64"] = max(worst["float64"], err)
                inp32 = [x.float() for x in inp]
                got32 = _tuple(card(inp32))
                want32 = _tuple(plain(inp32))
                for g, w32, w in zip(got32, want32, want):
                    if not w.abs().max():  # the states of a single row
                        assert not g.abs().max(), (name, kind, N, C)
                        continue
                    err = scaled_err(g, w)
                    tol = max(1e-4, 2 * scaled_err(w32, w))
                    assert math.isfinite(err) and err <= tol, (name, kind, N, C, err, tol)
                    worst["float32"] = max(worst["float32"], err)
        t, c, a, U, V, y = system(kind, 3000, 3, dev, seed=J)
        a = torch.where(torch.arange(3000, device=dev) >= 1000, -1.0, a)
        inp = fl.pass_inputs(t, c, a, U, V, y)["kalman_fwd"]
        S, F = KERNELS["kalman_fwd"][1](*inp)
        Sp, Fp = KERNELS["kalman_fwd"][0](*inp, 256)
        assert torch.isfinite(S).all() and torch.isfinite(F).all(), kind
        dk, dp = (a - (U * (x @ U[..., None])[..., 0]).sum(-1) for x in (S, Sp))
        assert torch.equal((dk > 0).all(-1), (dp > 0).all(-1)), kind
        rows = slice(0, int((dp <= 0).int().argmax(-1).min()) + 1)
        err = max(scaled_err(S[:, rows], Sp[:, rows]), scaled_err(F[:, rows], Fp[:, rows]))
        assert err < 1e-10, (kind, err)
    log("kernels", f"K1 to K5 at their edges (N = 1, a tile of rows and a "
        f"block +-1, ragged blocks, runs of three groups a scan thread, C = 3, "
        f"64; J = 1..4, K3 J = 1, 2): worst relative error "
        f"{worst['float64']:.3e} in float64, {worst['float32']:.3e} in float32; "
        "K1 on non-PD rows: finite, the same verdict d > 0")


def _tuple(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def phase_kernels(dev):
    """Each kernel against its plain version on the card, float64, at
    J = 1..4 (K3 at J <= 2; K4, K5 at J = 2..4); at J = 2 also the
    structured route's MX against K3's; K1, K2, K3 and K5 at their edges.
    Then each kernel's time."""
    worst = {name: (0.0, set()) for name in KERNELS}
    worst_mx = 0.0
    main_abs, main_inputs = {}, {}
    for kind, J in KINDS:
        for N, C in GEOMETRIES:
            args = system(kind, N, C, dev, seed=N + J)
            inputs = fl.pass_inputs(*args)
            if J == 2:
                inputs.update(fl.pass_inputs(*args, structured=True))
            for name, inp in inputs.items():
                got = _tuple(kernel_call(name, inp))
                want = _tuple(KERNELS[name][0](*inp, plain_len(name, N, C)))
                # the kernels that run a whole scan over 1e5 rows hold to
                # 1e-9, as the factor kernels do; K4's maps, composed over
                # 32 blocks at most, to 1e-10
                tol = 1e-9 if name != "frev_maps" and N > 10_000 else 1e-10
                for g, w in zip(got, want):
                    assert g.shape == w.shape, (name, kind, N, C)
                    err = scaled_err(g, w)
                    assert math.isfinite(err) and err < tol, (name, kind, N, C, err)
                    worst[name] = (max(worst[name][0], err), worst[name][1] | {J})
                main = (N, C) == (N_MAIN, 1) and J == REPORT_J[name] and kind in (
                    "sho", "sho_mixture")
                if main:
                    main_abs[name] = max(
                        (g - w).abs().max().item() for g, w in zip(got, want))
                    main_inputs[name] = inp
            if J == 2:
                fin = inputs["frev_maps"]
                L = fl.default_block_len(N)
                dense = fl.factor_adjoint(*fin, L, structured=False)
                structured = fl.factor_adjoint(*fin, L, structured=True)
                err = scaled_err(structured, dense)
                assert err < (1e-9 if N > 10_000 else 1e-10), ("MX", N, C, err)
                worst_mx = max(worst_mx, err)
    for name, (err, Js) in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = "
            f"{', '.join(map(str, sorted(Js)))}; N = 130, 1040, 1e5 at C = 1; "
            "N = 3001 at C = 8)")
    log("kernels", f"J = 2, structured (K4 -> B -> K5) vs dense (K3) MX on "
        f"the card: worst relative error {worst_mx:.3e}")
    k12_edges(dev)
    times = {}
    for name, (plain, kernel) in KERNELS.items():
        inp = main_inputs[name]
        L = plain_len(name, N_MAIN)
        ms = cuda_ms(lambda: kernel_call(name, inp), reps=20)
        plain_ms = cuda_ms(lambda: plain(*inp, L), reps=2, warmup=1)
        out = _tuple(kernel_call(name, inp))
        J = REPORT_J[name]
        bound, by = bound_ms((*inp, *out), kernel_flops(name, 1, N_MAIN, J))
        times[name] = (ms, plain_ms, bound, by)
        rows = card_len(name, N_MAIN)
        log("kernels", f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms at L = {L}, "
            f"bound {bound:.4f} ms by {by}) at N = 1e5, J = {J}, {rows} rows a "
            "block on the card, float64")
    # the J = 2 path's K1, K2
    j2 = fl.pass_inputs(*system("sho", N_MAIN, 1, dev, seed=N_MAIN + 2))
    for name in K12:
        ms = cuda_ms(lambda: kernel_call(name, j2[name]), reps=20)
        out = _tuple(kernel_call(name, j2[name]))
        bound, by = bound_ms((*j2[name], *out), kernel_flops(name, 1, N_MAIN, 2))
        log("kernels", f"{name}: {ms:.4f} ms (bound {bound:.4f} ms by {by}) at "
            "N = 1e5, J = 2, float64")
    return main_abs, times


# K4 and K5 timed at (J, N, C): the J = 3 RealTerm + SHOTerm and config5's
# J = 4 SHO mixture at N = 1e5, and config5's own N = 1e6 at J = 4 (128 rows
# a block); one chain and 64
FREV_SHAPES = ((3, N_MAIN, 1), (3, N_MAIN, 64), (4, N_MAIN, 1),
               (4, N_MAIN, 64), (4, 1_000_000, 1), (4, 1_000_000, 64))


def frev_inputs(J, N, C, dev):
    """K4's inputs (p, U, W, bv0, bdp), float64, of one chain of N rows at
    width J (``real_sho`` at J = 3, ``sho_mixture`` at 4), repeated over C
    chains: the kernels' work does not depend on the values."""
    kind = "real_sho" if J == 3 else "sho_mixture"
    fin = fl.pass_inputs(*system(kind, N, 1, dev, seed=N + J),
                         structured=True)["frev_maps"]
    return [x.repeat(C, *(1,) * (x.dim() - 1)) for x in fin]


def frev_bounds(J, N, C, dtype, L):
    """The bounds of K4, K5 and the two together in blocks of L rows,
    ``(ms, by)`` each: the bytes of the rows' 4J + 1 values, read by each,
    K4's suffixes and group maps (written by K4, read by K5) and MX
    (written by K5), and the operations of :func:`kernel_flops`; together
    the rows and MX only."""
    NB = -(-N // L)
    D = J * J
    maps = C * (NB + -(-NB // _build.FUSED_GROUP)) * (D * D + D) if NB > 1 else 0
    rows, mx = C * N * (4 * J + 1), C * N * D
    size = torch.empty((), dtype=dtype).element_size()
    f4, f5 = (kernel_flops(k, C, N, J, L=L) for k in ("frev_maps", "frev_states"))
    return {"frev_maps": bytes_or_ops(size * (rows + maps), f4, dtype),
            "frev_states": bytes_or_ops(size * (rows + maps + mx), f5, dtype),
            "both": bytes_or_ops(size * (rows + mx), f4 + f5, dtype)}


def frev_times(dev, shapes=FREV_SHAPES, reps=20):
    """K4, K5 (from K4's outputs) and the two together, ms per call by CUDA
    events over ``reps`` calls, at each (J, N, C) of ``shapes`` in float64
    and float32, in the card's own blocks, beside their bounds
    (:func:`frev_bounds`) and each device kernel's ms per call of the two
    together under torch.profiler (None when the trace holds no device
    events).  ``_build.frev_maps_cuda`` may return a tuple of outputs or
    one tensor of block maps, and the rows a block follow
    ``_build.factor_adjoint_block_len`` where the package has no
    ``structured_block_len`` (an older checkout's, which fused_turns.py
    times with this).  Returns one dict per shape and type."""
    rule = getattr(_build, "structured_block_len", None)
    out = []
    for J, N, C in shapes:
        L = rule(N, C) if rule else _build.factor_adjoint_block_len(N)
        base = frev_inputs(J, N, C, dev)
        for dtype in (torch.float64, torch.float32):
            fin = [x.to(dtype) for x in base]
            maps = _tuple(_build.frev_maps_cuda(*fin))

            def both():
                return _build.frev_states_cuda(
                    *fin, *_tuple(_build.frev_maps_cuda(*fin)))

            ms = {"frev_maps": cuda_ms(lambda: _build.frev_maps_cuda(*fin), reps),
                  "frev_states": cuda_ms(
                      lambda: _build.frev_states_cuda(*fin, *maps), reps),
                  "both": cuda_ms(both, reps)}
            prof = profile_calls(both, J)
            bounds = frev_bounds(J, N, C, dtype, L)
            row = {"J": J, "N": N, "C": C, "dtype": str(dtype)[6:],
                   "rows": L, "ms": ms,
                   "bound_ms": {k: b for k, (b, _) in bounds.items()},
                   "bound_by": {k: by for k, (_, by) in bounds.items()},
                   "device_ms": None if prof is None else
                   {k: ms_ for k, (_, ms_) in prof["parts"].items()}}
            log("frev", f"J = {J}, N = {N}, C = {C}, {row['dtype']}, {row['rows']} "
                "rows a block: " + "; ".join(
                    f"{k} {ms[k]:.4f} ms (bound {b:.4f} by {by})"
                    for k, (b, by) in bounds.items())
                + "; device ms per call: " + ("not measured" if prof is None else
                                              ", ".join(f"{k} {v:.4f}" for k, v in
                                                        row["device_ms"].items())))
            out.append(row)
            del fin, maps
        del base
        torch.cuda.empty_cache()
    return out


def phase_frev(dev):
    """K4 on its own outputs and K5 from them against their plain versions
    at config5's N = 1e6, J = 4, float64 (1e-9), then their times
    (:func:`frev_times`)."""
    N = 1_000_000
    fin = frev_inputs(4, N, 1, dev)
    L = _build.structured_block_len(N)
    maps = _build.frev_maps_cuda(*fin)
    errs = [scaled_err(g, w) for g, w in zip(maps, fl.frev_maps_plain(*fin, L))]
    errs.append(scaled_err(_build.frev_states_cuda(*fin, *maps),
                           fl.frev_states_plain(*fin, *maps, L)))
    log("frev", f"J = 4, N = 1e6, {L} rows a block: suffix, groups, MX against "
        "the plain versions: " + ", ".join(f"{e:.3e}" for e in errs) + " (tol 1e-9)")
    assert all(math.isfinite(e) and e < 1e-9 for e in errs), errs
    del fin, maps
    return frev_times(dev)


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
    """``(p, A, B)`` of a sweep mode (:func:`sweep_inputs`), with its
    transport computed here."""
    p = scan.transport_up(t, c) if MODES[mode][1] else scan.transport(t, c)
    return sweep_inputs(mode, (t, c, None, U, V, None, p, p), W)


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


class PhaseClock:
    """``[time]`` lines for the sections of a phase: each section's seconds
    and, of them, the seconds spent in the plain versions of the general
    recursions (each call ended by a synchronize) and the seconds spent
    waiting for references from the CPU (``waiting``)."""

    PLAIN = ("factor_fwd_plain", "sweep_fwd_plain", "factor_bwd_plain",
             "sweep_bwd_plain")

    def __init__(self, phase):
        self.phase = phase
        self.section = None
        self.saved = {n: getattr(scan, n) for n in self.PLAIN}
        for n, fn in self.saved.items():
            setattr(scan, n, self._clocked(fn))

    def _clocked(self, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            began = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.plain += time.perf_counter() - began
            return out
        return wrapped

    def waiting(self, fn):
        """``fn()``, its seconds counted as waiting for the CPU."""
        began = time.perf_counter()
        out = fn()
        self.waited += time.perf_counter() - began
        return out

    def start(self, section):
        self._close()
        torch.cuda.synchronize()
        self.section, self.plain, self.waited = section, 0.0, 0.0
        self.began = time.perf_counter()

    def _close(self):
        if self.section is None:
            return
        torch.cuda.synchronize()
        total = time.perf_counter() - self.began
        log("time", f"{self.phase} {self.section}: {total:.1f} s, of which "
            f"the plain versions on the card {self.plain:.1f} s, waiting for "
            f"the CPU's references {self.waited:.1f} s, the kernels and the "
            f"rest {total - self.plain - self.waited:.1f} s")
        self.section = None

    def stop(self):
        self._close()
        for n, fn in self.saved.items():
            setattr(scan, n, fn)


def forward_checks(system, nonpositive=False):
    """(name, kernel outputs, plain outputs) of factor_fwd and sweep_fwd in
    its four modes on ``system`` (``wide_system``'s tuple), caches
    included; the sweeps take the plain version's W.  Without the caches
    the kernels must give the same bits (d, W, Z).  With ``nonpositive``
    two pivots are made d <= 0 (a = 0 at row 7, a = -1 at row 100), which
    both versions divide by 1."""
    t, c, a, U, V, Y = system
    if nonpositive:
        a = a.clone()
        a[:, 7] = 0.0
        a[:, 100] = -1.0
    fin = (scan.transport(t, c), a, U, V)
    want = scan.factor_fwd_plain(*fin)
    if nonpositive:
        assert (want[0] <= 0).any()
    got = _build.factor_fwd_cuda(*fin, want_cache=True)
    d, W, none = _build.factor_fwd_cuda(*fin)
    assert none is None and torch.equal(d, got[0]) and torch.equal(W, got[1])
    checks = [("factor_fwd", got, want)]
    for mode, (is_solve, upper) in MODES.items():
        sin = (*sweep_args(mode, t, c, U, V, want[1]), Y)
        got = _build.sweep_fwd_cuda(*sin, is_solve, upper, True)
        Z, none = _build.sweep_fwd_cuda(*sin, is_solve, upper)
        assert none is None and torch.equal(Z, got[0]), mode
        checks.append(("sweep_fwd", got, scan.sweep_fwd_plain(
            *sin, is_solve=is_solve, upper=upper)))
    return checks


def ring_line(name, J, K=1, C=1, **kw):
    """A ring's plan as text: float64 and float32 rows per tile, chains per
    block and shared memory."""
    opts = "".join(f" {k}={v}" for k, v in kw.items())
    return f"{name}{opts} K = {K}, C = {C}: " + ", ".join(
        "{} {} rows, {} a block, {} B".format(dt, *_build.ring(name, dtype, J, K, C, **kw))
        for dt, dtype in (("float64", torch.float64), ("float32", torch.float32)))


# The grids of the general kernels' phases: widths, rows, chains and right-
# hand sides; their systems split over two CPU workers, about even in the
# plain versions' time (J = 32 and 16 lead)
GRID_J = (1, 2, 3, 8, 16, 32)
GRID_N = (130, 1040, 10_000)
GRID_C, GRID_K = 8, 5
GRID_WORKERS = ((32, 3, 1), (16, 8, 2))


def cpu_system(J, N, C, K, seed):
    """``wide_system``'s tuple built on the CPU, with its two transports:
    ``(t, c, a, U, V, Y, p, p_up)``, the inputs that a kernel on the card
    (after a copy) and its plain version in a CPU worker share bit for
    bit."""
    t, c, a, U, V, Y = wide_system(J, N, C, K, "cpu", seed)
    return t, c, a, U, V, Y, scan.transport(t, c), scan.transport_up(t, c)


def sweep_inputs(mode, system, W):
    """``(p, A, B)`` of a sweep mode on a ``cpu_system`` tuple: the solves
    take W, the matmuls V; the upper sweeps project with the second matrix,
    feed with U and take the upward transport."""
    _, _, _, U, V, _, p, p_up = system
    is_solve, upper = MODES[mode]
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    return (p_up if upper else p), A, B


def as_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_numpy(v) for v in tree)
    return tree


def on_device(tree, dev):
    """numpy arrays (in tuples and dicts) as tensors on ``dev``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(on_device(v, dev) for v in tree)
    return tree


def plain_references(system, seed, sweep_modes=tuple(MODES), adjoints=True):
    """The plain versions on a ``cpu_system`` tuple, each run once: the
    factor (d, W, S_half); the sweeps (Z, F) on all K columns of Y and the
    factor's W; then random cotangents from ``seed`` (bd, bW, each sweep's
    bZ) and the adjoints on the forward's outputs: the factor's, and each
    sweep's on all columns and on the first.  The milliseconds of each
    plain version go under ``ms``."""
    _, _, a, U, V, Y, p, _ = system
    ms = {}

    def run(name, fn, *args, **kw):
        began = time.perf_counter()
        out = fn(*args, **kw)
        ms[name] = 1e3 * (time.perf_counter() - began)
        return out

    rng = np.random.default_rng(seed)
    d, W, S = run("factor_fwd", scan.factor_fwd_plain, p, a, U, V)
    out = {"factor": (d, W, S), "sweep": {}, "ms": ms}
    if adjoints:
        bd, bW = randn_like(d, rng), randn_like(W, rng)
        out.update(cot=(bd, bW), bZ={}, sweep_bwd={}, sweep_bwd1={},
                   factor_bwd=run("factor_bwd", scan.factor_bwd_plain,
                                  p, d, U, W, S, bd, bW))
    for mode in sweep_modes:
        is_solve, upper = MODES[mode]
        ps, A, B = sweep_inputs(mode, system, W)
        Z, F = run(f"sweep_fwd {mode}", scan.sweep_fwd_plain, ps, A, B, Y,
                   is_solve=is_solve, upper=upper)
        out["sweep"][mode] = (Z, F)
        if not adjoints:
            continue
        bZ = randn_like(Z, rng)
        R = Z if is_solve else Y
        out["bZ"][mode] = bZ
        out["sweep_bwd"][mode] = run(f"sweep_bwd {mode}", scan.sweep_bwd_plain,
                                     ps, A, B, R, F, bZ, is_solve=is_solve,
                                     upper=upper)
        out["sweep_bwd1"][mode] = scan.sweep_bwd_plain(
            ps, A, B, *(x[..., :1].contiguous() for x in (R, F, bZ)),
            is_solve=is_solve, upper=upper)
    return out


def grid_seed(J, N):
    return J + N


def grid_references(Js):
    """The grids' plain references (:func:`plain_references`) at
    J in ``Js``, N in GRID_N, C = 8, K = 5, as numpy."""
    return {(J, N): as_numpy(plain_references(
                cpu_system(J, N, GRID_C, GRID_K, seed=grid_seed(J, N)), seed=J * N))
            for J in Js for N in GRID_N}


# the other right-hand sides the GP path's sweeps take at N = 1e5
MAIN_K_SHAPES = (("matmul_lower", 4), ("solve_lower", 500), ("solve_upper", 500))


def main_shape_references():
    """The plain references at the GP and training paths' shape, N = 1e5,
    J = 8, C = 1, K = 1 (each run once, shared by the two phases): the
    factor, the two solves with their caches, the factor's adjoint and the
    lower solve's; then each sweep of MAIN_K_SHAPES on its right-hand sides
    (numpy seed 9); and the milliseconds of each."""
    system = cpu_system(8, N_MAIN, 1, 1, seed=8)
    out = plain_references(system, seed=1, sweep_modes=("solve_lower",))
    began = time.perf_counter()
    out["sweep"]["solve_upper"] = scan.sweep_fwd_plain(
        *sweep_inputs("solve_upper", system, out["factor"][1]), system[5],
        is_solve=True, upper=True)
    out["ms"]["sweep_fwd solve_upper"] = 1e3 * (time.perf_counter() - began)
    rng = np.random.default_rng(9)
    out["K"] = {}
    for mode, K in MAIN_K_SHAPES:
        is_solve, up = MODES[mode]
        YK = torch.tensor(rng.normal(size=(1, N_MAIN, K)))
        began = time.perf_counter()
        Z, _ = scan.sweep_fwd_plain(*sweep_inputs(mode, system, out["factor"][1]), YK,
                                    is_solve=is_solve, upper=up)
        out["K"][mode, K] = (YK, Z, 1e3 * (time.perf_counter() - began))
    return as_numpy(out)


def phase_general_kernels(dev, grid_refs, main_refs):
    """factor_fwd and sweep_fwd (its four modes) against their plain
    versions, float64, caches included, to 1e-10 relative, at C = 8 and at
    C = 1 as the first of those chains (the plain version runs once on all
    eight, in the CPU workers ``grid_refs``, on the same inputs; the K = 1
    sweeps against the first column of the K = 5 ones).  Then the edges
    of their rings of row tiles: N = 1 and one row below and past a tile
    (C = 3; K = 1, 5, 200, 500), 64 chains, blocks of several chains (1023
    chains, the last block fewer),
    pivots d <= 0, and chains whose rows start off a 16-byte boundary (odd
    N at J = 1, 2, in float32 and float64); without the caches d, W and Z
    are the same bits.  Then their times at N = 1e5, J = 8, at C = 1 and
    C = 64, and at N = 3e4, C = 1024, with ns per row, and each sweep shape
    the GP path launches against the plain version at N = 1e5 (run once in
    the CPU worker ``main_refs``, whose time is the plain time reported).
    The times and bounds reported are those of the call the GP path makes:
    without the caches."""
    clock = PhaseClock("phase_general_kernels")
    clock.start("grids of J x N")
    grid = {}
    for refs in grid_refs:
        grid.update(clock.waiting(refs.get))
    worst = {"factor_fwd": 0.0, "sweep_fwd": 0.0}
    for J in GRID_J:
        for N in GRID_N:
            system = on_device(cpu_system(J, N, GRID_C, GRID_K, grid_seed(J, N)), dev)
            _, _, a, U, V, Y5, p, _ = system
            ref = on_device(grid[J, N], dev)
            fin = (p, a, U, V)
            want = ref["factor"]
            W = want[1]
            checks = [
                ("factor_fwd", _build.factor_fwd_cuda(*fin, want_cache=True), want),
                ("factor_fwd", _build.factor_fwd_cuda(*first_chain(fin), True),
                 [w[:1] for w in want]),
            ]
            for mode, (is_solve, upper) in MODES.items():
                ps, A, B = sweep_inputs(mode, system, W)
                Z5, F5 = ref["sweep"][mode]
                for Y, want in ((Y5[..., :1].contiguous(), (Z5[..., :1], F5[..., :1])),
                                (Y5, (Z5, F5))):
                    sin = (ps, A, B, Y)
                    checks += [
                        ("sweep_fwd", _build.sweep_fwd_cuda(*sin, is_solve, upper, True),
                         want),
                        ("sweep_fwd", _build.sweep_fwd_cuda(
                            *first_chain(sin), is_solve, upper, True),
                         [w[:1] for w in want]),
                    ]
            hold_against_plain(checks, worst)
            del system, ref, checks
    for name, err in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = 1, 2, "
            "3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8 and 1; K = 1, 5; "
            "caches included; the plain versions in CPU workers)")

    # the rings' edges: rows per tile at each bucket, K, cache and mode
    clock.start("ring edges")
    edges = {"factor_fwd": 0.0, "sweep_fwd": 0.0}
    for J in (1, 2, 3, 8, 16, 32):
        Jb = J if J != 3 else 4
        for K in (1, 5, 200, 500):
            rows = {_build.ring("sweep_fwd", torch.float64, Jb, K, cache=cache,
                                is_solve=solve)[0]
                    for cache in (False, True) for solve in (False, True)}
            if K == 1:
                rows |= {_build.ring("factor_fwd", torch.float64, Jb, cache=cache)[0]
                         for cache in (False, True)}
            for N in sorted({1} | {r + e for r in rows for e in (-1, 1)}):
                system = wide_system(J, N, 3, K, dev, seed=J + K + N)
                hold_against_plain(forward_checks(system), edges)
        rings = "; ".join(
            [ring_line("factor_fwd", Jb, cache=cache) for cache in (False, True)]
            + [ring_line("sweep_fwd", Jb, K, cache=cache, is_solve=solve)
               for K, cache, solve in ((1, False, True), (1, True, True),
                                       (1, False, False), (500, False, True))])
        log("kernels", f"J = {J}: N = 1 and one row below and past a tile held "
            f"(K = 1, 5, 200, 500); the forward rings: {rings}")
    hold_against_plain(forward_checks(wide_system(8, 1040, 64, 1, dev, seed=64)),
                       edges)
    plans = ", ".join(
        f"C = {C}: " + " / ".join(
            "{1} ({0} rows)".format(*_build.ring(name, torch.float64, 8, 1, C,
                                                 cache=True))
            for name in ("factor_fwd", "sweep_fwd"))
        for C in (1, 264, 265, 300, 528, 529, 792, 793, 1024, 4096))
    log("kernels", "chains per block (rows per tile) of factor_fwd / sweep_fwd "
        f"with their caches at J = 8, K = 1, float64: {plans}")
    # blocks of several chains: 1023 chains (the last block fewer) over two
    # tiles at J = 2 and 8, K = 1 and 5
    for J in (2, 8):
        for K in (1, 5):
            plans = [_build.ring(name, torch.float64, J, K, 1023, cache=True)
                     for name in ("factor_fwd", "sweep_fwd")]
            N = max(r for r, _, _ in plans) + 1
            system = wide_system(J, N, 1023, K, dev, seed=J * K)
            hold_against_plain(forward_checks(system), edges)
            log("kernels", f"J = {J}, K = {K}, C = 1023, N = {N}: chains per "
                f"block (rows per tile) of factor_fwd, sweep_fwd: "
                + ", ".join(f"{c} ({r})" for r, c, _ in plans))
    system = wide_system(8, 1040, 3, 5, dev, seed=5)
    hold_against_plain(forward_checks(system, nonpositive=True)[:1], edges)
    worst32 = {"factor_fwd": 0.0, "sweep_fwd": 0.0}
    for J in (1, 2):
        for N in (131, 1041):
            for K in (1, 5):
                system = wide_system(J, N, 3, K, dev, seed=N + K)
                checks64 = forward_checks(system)
                hold_against_plain(checks64, edges)
                hold_float32(forward_checks(to_float32(system)), checks64, worst32)
    log("kernels", f"ring edges: worst relative error {edges} (float64: N = 1, "
        "tile +- 1 row, C = 3, K = 1, 5, 200, 500; C = 64; C = 1023; pivots "
        f"d <= 0; odd N at J = 1, 2); float32 against the float64 plain version "
        f"{worst32}; caches on and off the same bits")

    # times at the gp path's shapes: N = 1e5, J = 8, K = 1, float64
    clock.start("N = 1e5 shapes")
    main_abs, times = {}, {}
    per_row = 1e6 / N_MAIN  # ms per launch -> ns per row
    main = on_device(clock.waiting(main_refs.get), dev)
    plain_ms_of = main["ms"]
    for C in (1, 64):
        if C == 1:
            system = on_device(cpu_system(8, N_MAIN, 1, 1, seed=8), dev)
        else:
            t, c, a, U, V, Y = wide_system(8, N_MAIN, C, 1, dev, seed=8)
            system = (t, c, a, U, V, Y, scan.transport(t, c), scan.transport_up(t, c))
        t, c, a, U, V, Y, p, _ = system
        d, W, S = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
        ms_c = cuda_ms(lambda: _build.factor_fwd_cuda(p, a, U, V, True),
                       reps=5, warmup=1)
        ms = cuda_ms(lambda: _build.factor_fwd_cuda(p, a, U, V), reps=5, warmup=1)
        flops = kernel_flops("factor_fwd", C, N_MAIN, 8)
        bound, by = bound_ms((p, a, U, V, d, W), flops)
        bound_c, _ = bound_ms((p, a, U, V, d, W, S), flops)
        log("kernels", f"factor_fwd: {ms:.4f} ms, {ms * per_row:.1f} ns per row "
            f"(bound {bound:.4f} ms by {by}); with the cache {ms_c:.4f} ms, "
            f"{ms_c * per_row:.1f} ns per row (bound {bound_c:.4f} ms) at "
            f"N = 1e5, J = 8, C = {C}, float64; rings: "
            + "; ".join(ring_line("factor_fwd", 8, C=C, cache=cache)
                        for cache in (False, True)))
        if C == 1:
            want, plain_ms = main["factor"], plain_ms_of["factor_fwd"]
            log("kernels", f"factor_fwd: plain version {plain_ms:.1f} ms (one run "
                "on the CPU, in a worker)")
            main_abs["factor_fwd"] = held_at_main_shape(
                "factor_fwd", (d, W, S), want, "d, W, S_half")
            times["factor_fwd"] = (ms, plain_ms, bound, by)
            # the sweeps run on the plain version's W, as the plain sweeps did
            W = want[1]
        for mode, (is_solve, upper) in MODES.items():
            ps, A, B = sweep_inputs(mode, system, W)
            Z, F = _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper, True)
            ms_c = cuda_ms(
                lambda: _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper, True),
                reps=5, warmup=1)
            ms = cuda_ms(lambda: _build.sweep_fwd_cuda(ps, A, B, Y, is_solve, upper),
                         reps=5, warmup=1)
            flops = kernel_flops("sweep_fwd", C, N_MAIN, 8)
            bound, by = bound_ms((ps, A, B, Y, Z), flops)
            bound_c, _ = bound_ms((ps, A, B, Y, Z, F), flops)
            log("kernels", f"sweep_fwd {mode}: {ms:.4f} ms, {ms * per_row:.1f} ns "
                f"per row (bound {bound:.4f} ms by {by}); with the cache "
                f"{ms_c:.4f} ms, {ms_c * per_row:.1f} ns per row (bound "
                f"{bound_c:.4f} ms) at N = 1e5, J = 8, K = 1, C = {C}, float64")
            if C == 1 and mode in ("solve_lower", "solve_upper"):
                want = main["sweep"][mode]
                plain_ms = plain_ms_of[f"sweep_fwd {mode}"]
                log("kernels", f"sweep_fwd {mode}: plain version {plain_ms:.1f} ms "
                    "(one run on the CPU, in a worker)")
                err = held_at_main_shape("sweep_fwd", (Z, F), want, f"{mode} K = 1")
                if mode == "solve_lower":
                    main_abs["sweep_fwd"] = err
                    times["sweep_fwd"] = (ms, plain_ms, bound, by)
        if C == 1:
            # the other shapes the GP path launches: sample's matmul_lower
            # (K = 4) and the variance's solves on K = 500 columns (sixteen
            # blocks of right-hand sides per chain)
            for mode, K in MAIN_K_SHAPES:
                is_solve, upper = MODES[mode]
                ps, A, B = sweep_inputs(mode, system, W)
                YK, want, plain_ms = main["K"][mode, K]
                Z, _ = _build.sweep_fwd_cuda(ps, A, B, YK, is_solve, upper)
                ms = cuda_ms(
                    lambda: _build.sweep_fwd_cuda(ps, A, B, YK, is_solve, upper),
                    reps=3, warmup=1)
                bound, by = bound_ms((ps, A, B, YK, Z),
                                     kernel_flops("sweep_fwd", 1, N_MAIN, 8, K))
                log("kernels", f"sweep_fwd {mode}, K = {K}: {ms:.4f} ms, "
                    f"{ms * per_row:.1f} ns per row (bound {bound:.4f} ms by {by}; "
                    f"plain version {plain_ms:.1f} ms on the CPU) at N = 1e5, J = 8, "
                    "C = 1, "
                    f"float64; ring: " + ring_line("sweep_fwd", 8, K,
                                                   is_solve=is_solve))
                held_at_main_shape("sweep_fwd", (Z,), (want,), f"{mode} K = {K}")
    # a fleet of chains (the sampler's): C = 1024 at N = 3e4
    clock.start("C = 1024")
    C, N = 1024, 30_000
    t, c, a, U, V, Y = wide_system(8, N, C, 1, dev, seed=8)
    p = scan.transport(t, c)
    d, W, S = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
    Z, F = _build.sweep_fwd_cuda(p, U, W, Y, True, False, True)
    for name, fn, cache, arrays in (
            ("factor_fwd", lambda: _build.factor_fwd_cuda(p, a, U, V), False,
             (p, a, U, V, d, W)),
            ("factor_fwd", lambda: _build.factor_fwd_cuda(p, a, U, V, True), True,
             (p, a, U, V, d, W, S)),
            ("sweep_fwd solve_lower",
             lambda: _build.sweep_fwd_cuda(p, U, W, Y, True, False), False,
             (p, U, W, Y, Z)),
            ("sweep_fwd solve_lower",
             lambda: _build.sweep_fwd_cuda(p, U, W, Y, True, False, True), True,
             (p, U, W, Y, Z, F))):
        ms = cuda_ms(fn, reps=5, warmup=1)
        bound, by = bound_ms(arrays, kernel_flops(name.split()[0], C, N, 8))
        log("kernels", f"{name}{' with the cache' if cache else ''}: {ms:.4f} ms, "
            f"{ms * 1e6 / N:.1f} ns per row (bound {bound:.4f} ms by {by}) at "
            f"N = 3e4, J = 8, K = 1, C = {C}, float64; ring: "
            + ring_line(name.split()[0], 8, C=C, cache=cache))
    clock.stop()
    return main_abs, times


def prefix_rows(phi, G, reverse):
    """The affine recurrence row by row (what the doubling and the kernel
    both compute)."""
    F, rows = torch.zeros_like(G[:, 0]), [None] * G.shape[1]
    for m in range(G.shape[1] - 1, -1, -1) if reverse else range(G.shape[1]):
        F = phi[:, m, :, None] * F + G[:, m]
        rows[m] = F
    return torch.stack(rows, 1)


def prefix_rows_np(phi, G, reverse=False):
    """``prefix_rows`` of chain 0 on the CPU in numpy, float64 (fast enough
    for a million rows)."""
    P, Gn = phi[0].cpu().numpy(), G[0].cpu().numpy()
    F, out = np.zeros(Gn.shape[1:]), np.empty_like(Gn)
    for m in range(Gn.shape[0] - 1, -1, -1) if reverse else range(Gn.shape[0]):
        F = P[m][:, None] * F + Gn[m]
        out[m] = F
    return torch.from_numpy(out)[None]


def log_device_ms(phase, label, fn, J):
    """The device time of each kernel a call of ``fn`` launches
    (``profile_calls`` over 3 calls), beside its span: where a kernel's own
    time goes, and how much of a call's time the host takes."""
    prof = profile_calls(fn, J)
    if prof is None:
        log(phase, f"{label}: no device events in the trace: not measured")
        return
    log(phase, f"{label}: device busy {prof['busy_ms']:.4f} ms of a "
        f"{prof['span_ms']:.4f} ms span a call; " + "; ".join(
            f"{k} {ms:.4f} ms" for k, (_, ms) in prof["by_name"].items()))


def rect_inputs(J, N, C, K, dev, seed):
    """``(phi, G)`` of a rectangular product on ``wide_system``: the
    transport and G = V y^T, what ``ops.general_matmul_*`` hands the
    diagonal-affine prefix."""
    t, c, _, _, V, Y = wide_system(J, N, C, K, dev, seed=seed)
    return scan.transport(t, c), (V[..., None] * Y[..., None, :]).contiguous()


def phase_prefix_kernel(dev):
    """affine_prefix (the diagonal-affine prefix) against its plain version
    (the doubling) on the card, float64, to 1e-10 relative, in both
    directions, and against the row-by-row recurrence at M <= 1040; in
    float32 (J = 8, M = 1e4) within max(1e-4, 2 x the float32 doubling's
    error) of the float64 recurrence.  Then at the shapes the GP path gives
    it, M = 1e5 source rows, K = 1: its time beside its bound and its
    launches per call at J = 2, 4, 8 with C = 1 and 64 (and K = 64 with
    one chain at J = 8), and at C = 1 the same checks at 1e-9 (the
    recurrence of chain 0 in numpy); at M = 1e6, J = 2, 4, 8, one chain,
    against the doubling and the recurrence at 1e-9."""
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
    phi, G = rect_inputs(8, 10_000, 3, 1, dev, seed=8)
    rows = prefix_rows(phi, G, False)
    got = _build.affine_prefix_cuda(phi.float(), G.float())
    err32 = scaled_err(got, rows)
    tol32 = max(1e-4, 2 * scaled_err(scan.affine_prefix_plain(phi.float(), G.float()), rows))
    log("kernels", f"affine_prefix float32, J = 8, M = 1e4, C = 3: {err32:.2e} against "
        f"the float64 recurrence (tol {tol32:.2e})")
    assert torch.isfinite(got).all() and err32 < tol32, (err32, tol32)
    main_abs, times = {}, {}
    for J in (2, 4, 8):
        for C, K in ((1, 1), (64, 1)) + (((1, 64),) if J == 8 else ()):
            phi, G = rect_inputs(J, N_MAIN, C, K, dev, seed=J)
            before = _build.LAUNCHES["affine_prefix"]
            got = _build.affine_prefix_cuda(phi, G)
            torch.cuda.synchronize()
            per_call = _build.LAUNCHES["affine_prefix"] - before
            want = scan.affine_prefix_plain(phi, G)
            err = scaled_err(got, want)
            assert math.isfinite(err) and err < 1e-10, ("affine_prefix", J, C, K, err)
            ms = cuda_ms(lambda: _build.affine_prefix_cuda(phi, G), reps=20)
            plain_ms = cuda_ms(lambda: scan.affine_prefix_plain(phi, G), reps=5)
            bound, by = bound_ms((phi, G, got),
                                 kernel_flops("affine_prefix", C, N_MAIN, J, K))
            line = (f"affine_prefix: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms by {by}; relative error {err:.3e} against the "
                    f"doubling) at M = 1e5, J = {J}, K = {K}, C = {C}, "
                    f"{_build.affine_run_len(N_MAIN)} rows a run, {per_call} "
                    "launches, float64")
            if C == 1 and K == 1:
                e_rows = scaled_err(got[:1], prefix_rows_np(phi, G))
                assert e_rows < LONG_RTOL, ("affine_prefix rows", J, e_rows)
                line += f"; {e_rows:.3e} against the row recurrence"
            log("kernels", line)
            if J == 8 and K == 1:
                log_device_ms("kernels", f"affine_prefix, J = 8, C = {C}",
                              lambda: _build.affine_prefix_cuda(phi, G), J)
            if (J, C, K) == (8, 1, 1):
                main_abs["affine_prefix"] = (got - want).abs().max().item()
                times["affine_prefix"] = (ms, plain_ms, bound, by)
    for J in (2, 4, 8):
        phi, G = rect_inputs(J, 1_000_000, 1, 1, dev, seed=J)
        got = _build.affine_prefix_cuda(phi, G)
        e_dbl = scaled_err(got, scan.affine_prefix_plain(phi, G))
        e_rows = scaled_err(got, prefix_rows_np(phi, G))
        log("kernels", f"affine_prefix at M = 1e6, J = {J}, K = 1, C = 1: relative "
            f"error {e_rows:.3e} against the row recurrence, {e_dbl:.3e} against "
            "the doubling")
        assert e_rows < LONG_RTOL and e_dbl < LONG_RTOL, (J, e_rows, e_dbl)
    return main_abs, times


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


def adjoint_checks(fin, sins, whole=True, first=True, factor=True, wants=None):
    """(name, kernel outputs, plain outputs) of factor_bwd (unless not
    ``factor``) and sweep_bwd in its four modes; with ``first`` also the
    first chain alone (the plain version runs once on all chains).
    ``wants``: the plain outputs, ``(factor_bwd's, {mode: sweep_bwd's})``,
    where a worker computed them; else the plain versions run here."""
    wanted = iter([] if wants is None else
                  ([wants[0]] if factor else []) + [wants[1][m] for m in MODES])

    def pair(name, kernel, plain, args):
        want = plain(*args) if wants is None else next(wanted)
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


def plain_adjoint_inputs(system, ref):
    """From a ``cpu_system`` tuple and its :func:`plain_references` (both
    on the card): factor_bwd's inputs ``(p, d, U, W, S_half, bd, bW)``,
    sweep_bwd's per mode ``(p, A, B, R, F, bZ)`` on all K columns, and the
    plain outputs on them, ``(factor_bwd's, {mode: sweep_bwd's})`` on all
    columns and ``(None, {mode: ...})`` on the first."""
    _, _, _, U, _, Y, p, _ = system
    d, W, S = ref["factor"]
    fin = (p, d, U, W, S, *ref["cot"])
    sins = {}
    for mode, bZ in ref["bZ"].items():
        Z, F = ref["sweep"][mode]
        sins[mode] = (*sweep_inputs(mode, system, W), Z if MODES[mode][0] else Y,
                      F, bZ)
    return (fin, sins, (ref.get("factor_bwd"), ref["sweep_bwd"]),
            (None, ref["sweep_bwd1"]))


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


def phase_adjoint_kernels(dev, grid_refs, main_refs):
    """factor_bwd and sweep_bwd (four modes) against their plain versions,
    float64, to 1e-10 relative, on the plain forward's outputs and random
    cotangents, all from the CPU workers ``grid_refs`` (the systems of
    ``phase_general_kernels``, whose plain forward there holds the kernels'
    forward): J = 1, 2, 3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8, and
    C = 1 as the first of those chains; K = 1, 5.
    Then the edges of their rings of row tiles: N = 1 and one row below and
    past a tile (C = 3; K = 1, 5, 200), 64 chains, blocks of several chains
    (the last one fewer), pivots d <= 0, and chains whose rows start off a
    16-byte boundary (odd N at J = 1, 2, in float32 and float64).  Then
    their times at N = 1e5, J = 8 (K = 1 in the four modes, and K = 5) at
    C = 1 and C = 64, and at C = 1024, N = 3e4 (K = 1, the lower solve's),
    with ns per row, and at C = 1 the factor and the lower solve's adjoint
    (the training path's shapes, on the plain forward's outputs from the
    CPU worker ``main_refs``) against the plain versions there to 1e-9
    (LONG_RTOL)."""
    clock = PhaseClock("phase_adjoint_kernels")
    clock.start("grids of J x N")
    grid = {}
    for refs in grid_refs:
        grid.update(clock.waiting(refs.get))
    worst = {"factor_bwd": 0.0, "sweep_bwd": 0.0}
    for J in GRID_J:
        for N in GRID_N:
            system = on_device(cpu_system(J, N, GRID_C, GRID_K, grid_seed(J, N)), dev)
            fin, sins, wants, wants1 = plain_adjoint_inputs(
                system, on_device(grid[J, N], dev))
            sins1 = {m: s[:3] + tuple(x[..., :1].contiguous() for x in s[3:])
                     for m, s in sins.items()}
            hold_against_plain(adjoint_checks(fin, sins, wants=wants), worst)
            hold_against_plain(adjoint_checks(fin, sins1, factor=False,
                                              wants=wants1), worst)
            del system, fin, sins, sins1, wants, wants1
    for name, err in worst.items():
        log("kernels", f"{name}: worst relative error {err:.3e} (J = 1, 2, "
            "3 -> 4, 8, 16, 32; N = 130, 1040, 1e4; C = 8 and 1; K = 1, 5 in "
            "four modes; the plain versions in CPU workers)")

    # the rings' edges: rows per tile at each bucket, K and type
    clock.start("ring edges")
    edges = {"factor_bwd": 0.0, "sweep_bwd": 0.0}
    for J in (1, 2, 3, 8, 16, 32):
        Jb = J if J != 3 else 4
        for K in (1, 5, 200):
            rows = {_build.ring("sweep_bwd", torch.float64, Jb, K)[0]}
            if K == 1:
                rows.add(_build.ring("factor_bwd", torch.float64, Jb)[0])
            for N in sorted({1} | {r + e for r in rows for e in (-1, 1)}):
                fin, sins = adjoint_inputs(J, N, 3, K, dev, seed=J + K)
                hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
        rings = ", ".join(
            f"{name} {dt} K = {K}: {r} rows, {b} B"
            for name, Ks in (("factor_bwd", (1,)), ("sweep_bwd", (1, 5, 200)))
            for K in Ks
            for dt, dtype in (("float64", torch.float64), ("float32", torch.float32))
            for r, _, b in (_build.ring(name, dtype, Jb, K),))
        log("kernels", f"J = {J}: N = 1 and one row below and past a tile held; "
            f"tiles of the rings (shared memory per block): {rings}")
    fin, sins = adjoint_inputs(8, 1040, 64, 1, dev, seed=64)
    hold_against_plain(adjoint_checks(fin, sins, first=False), edges)
    plans = ", ".join(
        f"C = {C}: " + " / ".join(
            "{1} ({0} rows)".format(*_build.ring(name, torch.float64, 8, 1, C))
            for name in ("factor_bwd", "sweep_bwd"))
        for C in (1, 264, 265, 300, 528, 529, 792, 793, 1024, 4096))
    log("kernels", "chains per block (rows per tile) of factor_bwd / sweep_bwd "
        f"at J = 8, K = 1, float64: {plans}")
    # blocks of several chains: 1023 chains (the last block fewer) over two
    # tiles at J = 2 and 8, K = 1 and 5
    for J in (2, 8):
        for K in (1, 5):
            plans = [_build.ring(name, torch.float64, J, K, 1023)
                     for name in ("factor_bwd", "sweep_bwd")]
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
    clock.start("N = 1e5 shapes")
    main_abs, times = {}, {}
    per_row = 1e6 / N_MAIN  # ms per launch -> ns per row
    main = on_device(clock.waiting(main_refs.get), dev)
    main_fin, main_sins, main_wants, _ = plain_adjoint_inputs(
        on_device(cpu_system(8, N_MAIN, 1, 1, seed=8), dev), main)
    for C in (1, 64):
        fin, sins = adjoint_inputs(8, N_MAIN, C, 1, dev, seed=C, data_seed=8)
        got = _build.factor_bwd_cuda(*fin)
        ms = cuda_ms(lambda: _build.factor_bwd_cuda(*fin), reps=5, warmup=1)
        bound, by = bound_ms((*fin, *got), kernel_flops("factor_bwd", C, N_MAIN, 8))
        log("kernels", f"factor_bwd: {ms:.4f} ms, {ms * per_row:.1f} ns per row "
            f"(bound {bound:.4f} ms by {by}) at N = 1e5, J = 8, C = {C}, float64")
        if C == 1:
            plain_ms = main["ms"]["factor_bwd"]
            log("kernels", f"factor_bwd: plain version {plain_ms:.1f} ms (one run "
                "on the CPU, in a worker)")
            main_abs["factor_bwd"] = held_at_main_shape(
                "factor_bwd", _build.factor_bwd_cuda(*main_fin), main_wants[0],
                "ba, bU, bV, bp")
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
                    plain_ms = main["ms"][f"sweep_bwd {mode}"]
                    log("kernels", f"sweep_bwd {mode}: plain version "
                        f"{plain_ms:.1f} ms (one run on the CPU, in a worker)")
                    main_abs["sweep_bwd"] = held_at_main_shape(
                        "sweep_bwd", _build.sweep_bwd_cuda(*main_sins[mode], True, False),
                        main_wants[1][mode], f"{mode} K = 1")
                    times["sweep_bwd"] = (ms, plain_ms, bound, by)
    # a fleet of chains (the sampler's): C = 1024 at N = 3e4
    clock.start("C = 1024")
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
    clock.stop()
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


# the float32 J = 8 fleet on the assoc tier (C5): its chains and rows, its
# theta spread, and the chains the CPU's plain route runs for comparison
# (every eighth; chain 48's float32 z overflows z^2 / d)
C5_CHAINS, C5_ROWS = 64, 30_000
C5_CPU_CHAINS = list(range(0, C5_CHAINS, 8))


def c5_thetas(device, dtype):
    noise = np.random.default_rng(17).normal(size=(C5_CHAINS, 3))
    return (torch.tensor(THETA0, device=device, dtype=dtype)
            + 0.1 * torch.tensor(noise, device=device, dtype=dtype))


def cpu_references(N):
    """What the GP path and the training path are held against, on the
    CPU's plain route at N rows, as numpy: per GP model the state's d, W and
    each call's (result, seconds) in float64; for the training path
    gp_loglik's value and theta-gradient for wide8 at THETA0 on bench's
    data, and its seconds, on the scan tier in float64 ("train") and in
    float32 ("train f32"), and on the assoc tier ("train assoc"); for the
    J = 8 model also the state and three calls on the assoc tier ("J=8
    assoc"); and the value and gradient of the float32 fleet of C5 on the
    assoc tier at C5_CPU_CHAINS ("assoc f32 fleet")."""
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
    t32, y32 = bench_data(N, "cpu", torch.float32)
    start = time.perf_counter()
    v, g = value_and_grad(torch.tensor(THETA0, dtype=torch.float32), t32, y32, wide8)
    out["train f32"] = (v.numpy(), g.numpy(), time.perf_counter() - start)
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
    t5, y5 = bench_data(C5_ROWS, "cpu", torch.float32)
    v, g = value_and_grad(c5_thetas("cpu", torch.float32)[C5_CPU_CHAINS], t5, y5, wide8)
    out["assoc f32 fleet"] = (v.numpy(), g.numpy())
    return out


def _cpu_references_worker(queue, fn, args):
    try:
        ct.set_config(device="cpu")
        torch.set_num_threads(1)
        queue.put(("ok", fn(*args)))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


class CpuReferences:
    """``fn(*args)`` in a worker process on the CPU, started at once, so
    that the plain versions (minutes at N = 1e5) run beside the card's
    phases.  ``fn`` is a function of this module that returns numpy
    arrays (in tuples and dicts)."""

    def __init__(self, fn, *args):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_cpu_references_worker,
                                 args=(self._queue, fn, args), daemon=True)
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
        # two rectangular products (its mean) of one prefix launch each
        assert launches[label]["factor_fwd"] == 1, launches[label]
        assert launches[label]["sweep_fwd"] == 12, launches[label]
        assert launches[label]["affine_prefix"] == 4, launches[label]

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

    # float32 against the same float64 reference, within 1e-3 or 1.5 times
    # the CPU's float32 plain route's own error, whichever is larger (the
    # J = 4 path's float32 gate)
    v32c, g32c, seconds = refs.get()["train f32"]
    cpu_ev = scaled_err(torch.from_numpy(v32c), ref[0])
    cpu_eg = scaled_err(torch.from_numpy(g32c), ref[1])
    tol_v, tol_g = max(F32_RTOL, 1.5 * cpu_ev), max(F32_RTOL, 1.5 * cpu_eg)
    log("train J=8", f"float32 plain route on the CPU ({seconds:.1f} s): value err "
        f"{cpu_ev:.2e}, grad err {cpu_eg:.2e}")
    t32, y32 = bench_data(N_MAIN, dev, torch.float32)
    _check_path("train J=8", {"gp_loglik float32": value_and_grad(
        thd.float(), t32, y32, wide8)}, {"gp_loglik float32": ref},
        {"gp_loglik float32": (tol_v, tol_g)}, 3)

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


def row_prefix(p, a, U, V, Y):
    """S and F after every row by the row recursion on the card: the scan
    tier's factor_fwd and sweep_fwd (a lower solve) with their caches, held
    against the plain row loop in phase "general kernels"."""
    _, W, S_half = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
    _, F = _build.sweep_fwd_cuda(p, U, W, Y, True, False, want_cache=True)
    return S_half * p[..., None, :], p[..., :, None] * F


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
    Then their times at N = 1e5, K = 1, C = 1 and 64, J = 2, 4, 8 (the
    matrix-affine one on the lower solve's elements), each beside its bound
    and with its launches per call, and at C = 1 the same checks at 1e-9
    (the row recursion: the plain loop at J = 8, the row kernels below
    it); at N = 1e6 against the row kernels and the doubling at 1e-9 (the
    Riccati and Kalman prefixes at J = 4 and 8, the matrix-affine one at
    J = 2, 4, 8); in float32 (J = 2, 4, 8, N = 1040) within max(1e-4, 2 x
    the float32 doubling's error) of the float64 row recursion; the
    matrix-affine prefix at phase B's shape (98 maps of 64 x 64)."""
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

    # float32: the Riccati and Kalman prefixes at J = 2, 4, 8, N = 1040 in
    # blocks of 8 rows (130 blocks), C = 3, K = 1, against the float64 row
    # recursion within max(1e-4, 2 x the float32 doubling's error)
    for J in (2, 4, 8):
        p, a, U, V, Y = prefix_inputs(J, 1040, 3, 1, dev, seed=J)
        rows = sequential_prefix("kalman_prefix", (p, a, U, V, Y))
        x32 = [x.float() for x in (p, a, U, V, Y)]
        got = (_build.riccati_prefix_cuda(*x32[:4], block_len=8),
               *_build.kalman_prefix_cuda(*x32, block_len=8))
        plain = pe.kalman_prefix_plain(*x32)
        errs = []
        for g, d, r in zip(got, (plain[0],) + plain, (rows[0],) + rows):
            err, tol = scaled_err(g, r), max(1e-4, 2 * scaled_err(d, r))
            assert torch.isfinite(g).all() and err < tol, (J, err, tol)
            errs.append(f"{err:.2e} (tol {tol:.2e})")
        log("assoc", f"float32, J = {J}, N = 1040, L = 8: riccati_prefix S, "
            f"kalman_prefix S, F against the float64 row recursion: "
            + ", ".join(errs))

    # times at N = 1e5, K = 1, float64: J = 2, 4 (the route "auto" takes)
    # and 8 (the assoc path's); C = 1 and 64.  The kernels line keeps J = 8,
    # C = 1.
    main_abs, times = {}, {}
    for J in (2, 4, 8):
        for C in (1, 64):
            p, a, U, V, Y = prefix_inputs(J, N_MAIN, C, 1, dev, seed=J)
            fin = (p, a, U, V)
            runs = {
                "riccati_prefix": (lambda: (_build.riccati_prefix_cuda(*fin),),
                                   lambda: (pe.riccati_prefix_plain(*fin),), fin),
                "kalman_prefix": (lambda: _build.kalman_prefix_cuda(*fin, Y),
                                  lambda: pe.kalman_prefix_plain(*fin, Y), fin + (Y,)),
            }
            W = _build.factor_fwd_cuda(*fin)[1]
            A, b = assoc.solve_elements(p, U, W, Y)
            runs["mat_affine_prefix"] = (
                lambda: (_build.mat_affine_prefix_cuda(A, b),),
                lambda: (pe.mat_affine_prefix_plain(A, b),), (A, b))
            if C == 1:
                # one row recursion serves the Riccati and Kalman families:
                # the plain loop at J = 8, the row kernels below it
                S, F = (sequential_prefix("kalman_prefix", fin + (Y,)) if J == 8
                        else row_prefix(*fin, Y))
                rows = {"riccati_prefix": (S,), "kalman_prefix": (S, F),
                        "mat_affine_prefix": (sequential_prefix(
                            "mat_affine_prefix", (A, b)) if J == 8 else (F,))}
            for name, (kernel, plain, inputs) in runs.items():
                before = _build.LAUNCHES[name]
                got = kernel()
                torch.cuda.synchronize()
                per_call = _build.LAUNCHES[name] - before
                ms = cuda_ms(kernel, reps=5, warmup=1)
                bound, by = bound_ms((*inputs, *got), kernel_flops(name, C, N_MAIN, J))
                L = (_build.mat_affine_block_len(N_MAIN, J) if name == "mat_affine_prefix"
                     else _build.kalman_block_len(N_MAIN, J))
                log("assoc", f"{name}: {ms:.4f} ms (bound {bound:.4f} ms by {by}; "
                    f"{per_call} launches, L = {L}) at N = 1e5, J = {J}, K = 1, "
                    f"C = {C}, float64")
                if name == "mat_affine_prefix" and J > 2:
                    log_device_ms("assoc", f"{name}, J = {J}, C = {C}", kernel, J)
                if C == 1:
                    dbl, plain_ms = timed_plain(plain)
                    log("assoc", f"{name}: plain version {plain_ms:.1f} ms (one run)")
                    main = {name: (0.0, 0.0, 0.0)}
                    hold_prefix([(name, got, dbl, rows[name])], main, tol=LONG_RTOL)
                    log("assoc", f"{name} at N = 1e5, J = {J}: relative error "
                        f"{main[name][0]:.3e} against the row recursion, "
                        f"{main[name][1]:.3e} against the doubling (its own "
                        f"distance {main[name][2]:.3e})")
                    if J == 8:
                        main_abs[name] = max((g - d).abs().max().item()
                                             for g, d in zip(got, dbl))
                        times[name] = (ms, plain_ms, bound, by)
            del p, a, U, V, Y, fin, runs, got, A, b, W
            torch.cuda.empty_cache()
    # N = 1e6, one chain: against the row kernels and the doubling at 1e-9
    for J in (2, 4, 8):
        p, a, U, V, Y = prefix_inputs(J, 1_000_000, 1, 1, dev, seed=J)
        fin = (p, a, U, V)
        S, F = row_prefix(*fin, Y)
        A, b = assoc.solve_elements(p, U, _build.factor_fwd_cuda(*fin)[1], Y)
        checks = [("mat_affine_prefix", (_build.mat_affine_prefix_cuda(A, b),),
                   (pe.mat_affine_prefix_plain(A, b),), (F,))]
        if J > 2:
            dS, dF = pe.kalman_prefix_plain(*fin, Y)
            checks += [("riccati_prefix", (_build.riccati_prefix_cuda(*fin),), (dS,),
                        (S,)),
                       ("kalman_prefix", _build.kalman_prefix_cuda(*fin, Y), (dS, dF),
                        (S, F))]
        main = {name: (0.0, 0.0, 0.0) for name, *_ in checks}
        hold_prefix(checks, main, tol=LONG_RTOL)
        log("assoc", f"N = 1e6, J = {J}, C = 1 (L = {_build.kalman_block_len(10**6, J)}"
            f", matrix-affine {_build.mat_affine_block_len(10**6, J)}): relative "
            f"errors (against the row kernels, the doubling, the doubling's own) "
            f"{main}")
        del p, a, U, V, Y, fin, S, F, A, b, checks
        torch.cuda.empty_cache()
    # the shape of the factor adjoint's phase B at N = 1e5, J = 8, C = 1:
    # the prefix of ceil(N / L) maps of 64 x 64 (contracting random maps:
    # the adjoint's own maps are checked above, and on the path)
    NB = -(-N_MAIN // assoc.frev_block_len(1, N_MAIN, 8))
    rng = np.random.default_rng(5)
    A = torch.tensor(rng.normal(size=(1, NB, 64, 64)) / 12.0, device=dev)
    b = torch.tensor(rng.normal(size=(1, NB, 64, 1)), device=dev)
    before = _build.LAUNCHES["mat_affine_prefix"]
    got = _build.mat_affine_prefix_cuda(A, b)
    per_call = _build.LAUNCHES["mat_affine_prefix"] - before
    ms = cuda_ms(lambda: _build.mat_affine_prefix_cuda(A, b), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: pe.mat_affine_prefix_plain(A, b), reps=5, warmup=1)
    bound, by = bound_ms((A, b, got), 2 * NB * 64 * 64)
    main = {"mat_affine_prefix": (0.0, 0.0, 0.0)}
    hold_prefix([("mat_affine_prefix", (got,), (pe.mat_affine_prefix_plain(A, b),),
                  sequential_prefix("mat_affine_prefix", (A, b)))], main)
    log("assoc", f"mat_affine_prefix at phase B's shape (M = {NB} maps of 64 x 64, "
        f"K = 1, C = 1): {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound:.4f} "
        f"ms by {by}; {per_call} launch), relative errors {main}")
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
    ok = (d > 0).all(-1)  # gp_loglik's quiet -inf with zero gradients
    d = torch.where(ok[..., None], d, 1.0)
    z = torch.where(ok[..., None], z[..., 0], 0.0)
    ll = -0.5 * (torch.log(d).sum(-1) + (z**2 / d).sum(-1)
                 + t.shape[-1] * math.log(2 * math.pi))
    ll = torch.where(ok, ll, -math.inf)
    (g,) = torch.autograd.grad(ll.sum(), theta)
    return ll.detach(), g


def phase_assoc_path(dev, smi, refs):
    """The J = 8 path with backend="assoc" at N = 1e5, float64, one chain:
    GaussianProcess compute, log_likelihood, apply_inverse, predict(y)
    against the CPU references of the GP phase, and gp_loglik's value and
    theta-gradient against the training phase's: each to 1e-9 (the
    gradient 1e-8 scaled), or to 1.5 times the error of the CPU's plain
    assoc route against the same reference if that is larger; launches per
    call; non-PD; 8 chains against a loop; float32, one chain at N = 1e5
    and the fleet of C5 (64 chains at N = 3e4): every chain's value finite,
    or -inf with zero gradients, never NaN, on the card and on the CPU's
    plain route (every eighth chain)."""
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
        t5, y5 = bench_data(C5_ROWS, dev, torch.float32)
        th5 = c5_thetas(dev, torch.float32)
        v5, g5 = value_and_grad(th5, t5, y5, wide8)
    with tier("scan"):
        v64 = value_and_grad(th5.double(), t5.double(), y5.double(), wide8)[0]
    v5, g5, v64 = v5.cpu(), g5.cpu(), v64.cpu()
    v5c, g5c = (torch.from_numpy(x) for x in refs.get()["assoc f32 fleet"])
    for where, v, g in (("card", v5, g5), ("CPU", v5c, g5c)):
        quiet = v == -math.inf
        assert not (torch.isnan(v).any() or torch.isnan(g).any()), where
        assert (torch.isfinite(v) | quiet).all(), where
        assert torch.isfinite(g).all() and (g[quiet] == 0).all(), where
    fin = torch.isfinite(v5)
    err = (((v5 - v64).abs() / v64.abs())[fin].max().item() if fin.any()
           else float("nan"))
    same = int(((v5[C5_CPU_CHAINS] == -math.inf) == (v5c == -math.inf)).sum())
    log("assoc path", f"float32 fleet, J = 8, C = {C5_CHAINS}, N = {C5_ROWS}: "
        f"card {int(fin.sum())} finite (largest relative distance from the "
        f"float64 scan tier {err:.2e}), {int((~fin).sum())} -inf with zero "
        f"gradients; CPU's plain route on chains {C5_CPU_CHAINS}: "
        f"{int(torch.isfinite(v5c).sum())} finite, "
        f"{int((v5c == -math.inf).sum())} -inf with zero gradients, the same "
        f"verdict as the card's on {same}; no NaN")
    if not ok32:
        assert (torch.float32, 8, False) not in dispatch.ASSOC_MIN_ROWS, (
            "auto sends float32 at J = 8 to the assoc tier, which fails its gate")
    return launches, ok32


def phase_auto_path(dev, smi):
    """The J = 4 GaussianProcess path (config5's SHO mixture) at N = 1e5,
    float64, one chain, under backend="auto", the route a user gets: the
    card's crossover (dispatch.ASSOC_MIN_ROWS) sends it to the assoc tier,
    so compute launches riccati_prefix.  Each call's time (CUDA events, 1
    warm-up, 5 runs) beside the same call on backend="scan", and the
    state d, W and each call's result against the scan tier's to 1e-9."""
    t, y, _, _ = gp_data(N_MAIN)
    calls = {
        "compute": lambda gp, ys: ct.GaussianProcess(GP_MODELS["J=4"](), t,
                                                     yerr=0.25, mean=0.1),
        "log_likelihood": lambda gp, ys: gp.log_likelihood(ys),
        "apply_inverse": lambda gp, ys: gp.apply_inverse(ys),
        "predict(y)": lambda gp, ys: gp.predict(ys),
    }
    out, ms, launches = {}, {}, {}
    for name in ("auto", "scan"):
        with tier(name), torch.no_grad():
            reset_launches()
            gp = calls["compute"](None, None)
            ys = gp.state.t.new_tensor(y)
            out[name] = {"state d": gp.state.d, "state W": gp.state.W}
            out[name].update({k: fn(gp, ys) for k, fn in calls.items()
                              if k != "compute"})
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in _build.LAUNCHES.items() if v}
            for k, fn in calls.items():
                ms[name, k] = cuda_ms(lambda: fn(gp, ys), reps=5, warmup=1)
    log("auto path", f"J = 4, N = 1e5, float64, C = 1 | {smi}")
    for k in calls:
        log("auto path", f"{k}: auto {ms['auto', k]:.3f} ms, scan "
            f"{ms['scan', k]:.3f} ms")
    for k, res in out["auto"].items():
        err = scaled_err(res, out["scan"][k])
        log("auto path", f"{k}: auto against scan {err:.2e}")
        assert res.is_cuda and torch.isfinite(res).all() and err < 1e-9, (k, err)
    log("auto path", f"launches: auto {launches['auto']}; scan {launches['scan']}")
    assert launches["auto"].get("riccati_prefix", 0) >= 1, launches["auto"]
    assert launches["auto"].get("factor_fwd", 0) == 0, launches["auto"]
    auto_gradient(t, y)
    # where compute's time goes under "auto": each of 7 calls timed on its
    # own (the spread), and a trace of 3
    with tier("auto"), torch.no_grad():
        each = sorted(cuda_ms(lambda: calls["compute"](None, None), reps=1,
                              warmup=0) for _ in range(7))
        prof = profile_calls(lambda: calls["compute"](None, None), 4)
    log("auto path", "compute under auto, 7 calls each timed: " + ", ".join(
        f"{ms:.3f}" for ms in each) + " ms")
    if prof is None:
        log("auto path", "no device events in the trace: not measured")
        return
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:8]
    log("auto path", f"compute under auto, traced: {prof['kernels_per_eval']:.0f} "
        f"device kernels a call, device busy {prof['busy_ms']:.3f} ms of a "
        f"{prof['span_ms']:.3f} ms span (idle share {prof['idle_share']:.3f}); "
        "device time by kernel (top 8): " + "; ".join(
            f"{k} x{c:.0f} {ms:.4f} ms" for k, (c, ms) in top))


def auto_gradient(t, y):
    """The value and theta-gradient of ``GaussianProcess.log_likelihood``
    for config5's SHO mixture at N = 1e5, float64, under backend="auto"
    (the assoc tier, whose factor adjoint at J = 4 is K4 and K5) against
    backend="scan" (``factor_bwd``), to 1e-9."""
    res = {}
    for name in ("auto", "scan"):
        with tier(name):
            reset_launches()
            theta = torch.tensor(THETA4, device="cuda", requires_grad=True)
            gp = ct.GaussianProcess(sho_mixture(theta), t, yerr=0.25, mean=0.1)
            ll = gp.log_likelihood(gp.state.t.new_tensor(y))
            (g,) = torch.autograd.grad(ll, theta)
            torch.cuda.synchronize()
            res[name] = (ll.detach(), g,
                         {k: v for k, v in _build.LAUNCHES.items() if v})
    ev = scaled_err(res["auto"][0], res["scan"][0])
    eg = scaled_err(res["auto"][1], res["scan"][1])
    log("auto path", f"log_likelihood and its gradient: auto against scan "
        f"value err {ev:.2e}, grad err {eg:.2e} (tol 1e-9); launches: auto "
        f"{res['auto'][2]}")
    assert all(torch.isfinite(x).all() for x in res["auto"][:2])
    assert ev < 1e-9 and eg < 1e-9, (ev, eg)
    assert res["auto"][2].get("frev_maps", 0) >= 1, res["auto"][2]


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


def steps_per_s(dev, dtype, n_steps=20, model=sho, theta0=THETA0, data=None):
    """Chained value+grad evaluations theta <- theta + 1e-9 g through
    gp_loglik, after two warm-up steps; ``data`` is (t, y) on the device
    (default: bench_data at N = 1e5)."""
    t, y = bench_data(N_MAIN, dev, dtype) if data is None else data

    def step(theta):
        theta = theta.detach().requires_grad_(True)
        ll = ct.gp_loglik(model(theta), t, y, yerr=0.25)
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
    # one value and gradient there against the plain route on the card
    theta = torch.tensor(THETA4, device=dev)
    got = value_and_grad(theta, *data, sho_mixture)
    with plain_route():
        want = value_and_grad(theta, *data, sho_mixture)
    ev, eg = scaled_err(got[0], want[0]), scaled_err(got[1], want[1])
    log("steps", f"J = 4, torch.float64, N = 1e6: kernel route against the "
        f"plain route on the card: value err {ev:.2e}, grad err {eg:.2e} "
        f"(tol 1e-9; K1 and K2 in {_build.fused_block_len(N)} rows a block)")
    assert all(torch.isfinite(x).all() for x in (*got, *want))
    assert ev < 1e-9 and eg < 1e-9, (ev, eg)


# the kernels of the fused passes as the profiler names them, by wrapper; the
# scan over the groups' maps serves K1 (KalmanMaps), K2 (AffineMaps of width
# J) and K3 (AffineMaps of width J^2), the rows of the factor adjoint K3
# (J <= 2) and K5 (J = 3, 4); frev_groups_kernel is K5's pass over K4's
# block maps in older checkouts, which fused_turns.py profiles beside this
FUSED_PARTS = {"kalman_fwd": ("kalman_maps_kernel", "kalman_states_kernel",
                              "KalmanMaps"),
               "solve_rev": ("solve_maps_kernel", "solve_states_kernel"),
               "factor_rev": ("factor_maps_kernel",),
               "frev_states": ("frev_groups_kernel", "frev_scan_kernel")}


def ours(name, J):
    """The wrapper in this repository that launched the device kernel
    ``name`` in an evaluation at width J, or None."""
    if m := re.search(r"AffineMaps<\w+, (\d+)>", name):
        return "solve_rev" if int(m[1]) == J else "factor_rev"
    if "frev_rows_kernel" in name:
        return "factor_rev" if J <= 2 else "frev_states"
    for key, parts in FUSED_PARTS.items():
        if any(part in name for part in parts):
            return key
    return next((k for k in (*KERNELS, *GENERAL) if f"{k}_kernel" in name), None)


def part_name(name):
    """A device kernel's function name, with the width of its maps."""
    m = re.search(r"(\w+_kernel)", name)
    width = re.search(r"(Kalman|Affine)Maps<\w+, (\d+)>", name)
    return (m[1] if m else name[:60]) + (f"<{width[1]}, {width[2]}>" if width else "")


def profile_calls(fn, J, n=3, host_ops=True):
    """torch.profiler over ``n`` calls of ``fn`` (at width J), after one
    outside it; ``host_ops=False`` traces the device alone.  Returns None when the trace holds no device events, else
    per call: device kernels, device busy and span ms, the idle share,
    (calls, device ms) by kernel, this repository's kernels under the name
    of the wrapper that launched them (:func:`ours`), and by device kernel
    for those (``parts``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / n
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / n
    by_name, parts = {}, {}
    for e in kernels:
        mine = ours(e.name, J)
        for table, name in ((by_name, mine or e.name[:60]),
                            (parts, part_name(e.name) if mine else None)):
            if name is not None:
                calls, us = table.get(name, (0, 0.0))
                table[name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    per_eval = lambda table: {k: (c / n, us / n / 1000)  # noqa: E731
                              for k, (c, us) in table.items()}
    return {"kernels_per_eval": len(kernels) / n, "busy_ms": busy / 1000,
            "span_ms": span / 1000, "idle_share": 1 - busy / span,
            "by_name": per_eval(by_name), "parts": per_eval(parts)}


def profile_eval(dev, model, theta0, J, n=3):
    """:func:`profile_calls` over value+gradient evaluations at N = 1e5,
    float64, of the model of width J."""
    t, y = bench_data(N_MAIN, dev, torch.float64)
    theta = torch.tensor(theta0, device=dev)
    return profile_calls(lambda: value_and_grad(theta, t, y, model), J, n)


def phase_profile(dev, label, model, theta0, J):
    """The profile of :func:`profile_eval`: device kernels per evaluation,
    device busy time, idle share and device time by kernel; on the fused
    path (J <= 4) the fall in device kernels per evaluation from the
    parent commit's count."""
    prof = profile_eval(dev, model, theta0, J)
    if prof is None:
        log("profile", "no device events in the trace: not measured")
        return
    per_eval, by_name = prof["kernels_per_eval"], prof["by_name"]
    log("profile", f"{label}, N = 1e5, float64: {per_eval:.0f} device "
        f"kernels per eval, device busy {prof['busy_ms']:.3f} ms of a "
        f"{prof['span_ms']:.3f} ms span per eval (idle share "
        f"{prof['idle_share']:.3f}; under the profiler)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log("profile", f"{label}: per eval, device time by kernel (top 8): " + "; ".join(
        f"{k} x{c:.0f} {ms:.4f} ms" for k, (c, ms) in top))
    log("profile", f"{label}: per eval, this repo's kernels: " + ", ".join(
        f"{k} x{by_name[k][0]:.0f} {by_name[k][1]:.4f} ms"
        for k in (*KERNELS, *GENERAL) if k in by_name))
    log("profile", f"{label}: per eval, by device kernel: " + ", ".join(
        f"{k} x{c:.0f} {ms:.4f} ms" for k, (c, ms) in prof["parts"].items()))
    if label in PARENT_KERNELS_PER_EVAL:
        fall = PARENT_KERNELS_PER_EVAL[label] - per_eval
        log("profile", f"{label}: {per_eval:.0f} device kernels per eval, "
            f"{fall:.0f} fewer than the parent commit's "
            f"{PARENT_KERNELS_PER_EVAL[label]} (at least {KERNELS_FALL[label]})")
        assert fall >= KERNELS_FALL[label], (label, per_eval)


@contextmanager
def card_block_len(name, rows):
    """``_build.<name>`` (``fused_block_len``: K1 and K2;
    ``factor_adjoint_block_len``: K3; ``structured_block_len``: K4 and K5;
    ``kalman_block_len``: the Riccati and Kalman prefixes) gives ``rows``
    rows a block, whatever it would choose."""
    saved = getattr(_build, name)
    setattr(_build, name, lambda *args: rows)
    try:
        yield
    finally:
        setattr(_build, name, saved)


SWEEP_ROWS = (16, 32, 64, 128, 256, 512, 1024)
PREFIX_SWEEP_ROWS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def phase_sweep(dev):
    """The fused kernels' time per block length on the card, float64:

    * K1 and K2 (one chain: J = 2 and 4 at N = 1e5, J = 4 at N = 1e6; 64
      chains: J = 2 and 4 at N = 3e4, J = 4 at N = 1e5, with the evals/s of
      the 64 chains' value and gradient when K1 and K2 take that block
      length);
    * the factor adjoint, K3 (J = 2) and K4 with K5 (J = 4), at N = 1e5 and
      1e6 with one chain and at N = 1e5 with 64, with the evals/s when it
      takes that block length and the relative error of that evaluation's
      value and gradient against the plain route on the card (in blocks of
      ``fl.default_block_len`` rows)."""
    sweep_k12(dev)
    sweep_factor_adjoint(dev)


SWEEP_MODELS = {2: (sho, THETA0), 4: (sho_mixture, THETA4)}


def sweep_k12(dev):
    """:func:`phase_sweep`'s K1 and K2."""
    models = SWEEP_MODELS
    rng = np.random.default_rng(17)
    for J, kind, N, C in ((2, "sho", N_MAIN, 1), (4, "sho_mixture", N_MAIN, 1),
                          (4, "sho_mixture", 1_000_000, 1),
                          (2, "sho", 30_000, 64), (4, "sho_mixture", 30_000, 64),
                          (4, "sho_mixture", N_MAIN, 64)):
        inputs = fl.pass_inputs(*system(kind, N, C, dev))
        if C > 1:
            model, theta0 = models[J]
            theta0 = theta0 + 0.1 * rng.normal(size=(C, len(theta0)))
            data = bench_data(N, dev, torch.float64, seed=8)
        for rows in SWEEP_ROWS:
            ms = {name: cuda_ms(lambda: KERNELS[name][1](*inputs[name], rows),
                                reps=20) for name in K12}
            line = (f"J = {J}, N = {N}, C = {C}, {rows} rows a block (NB = "
                    f"{-(-N // rows)}): kalman_fwd {ms['kalman_fwd']:.4f} ms, "
                    f"solve_rev {ms['solve_rev']:.4f} ms")
            if C > 1:
                with card_block_len("fused_block_len", rows):
                    rate = steps_per_s(dev, torch.float64, n_steps=10,
                                       model=model, theta0=theta0, data=data)
                line += f", {rate:.2f} evals/s of the {C} chains"
            if rows == _build.fused_block_len(N):
                line += " (the default)"
            log("sweep", line)


def sweep_factor_adjoint(dev):
    """:func:`phase_sweep`'s factor adjoint."""
    models = SWEEP_MODELS
    rng = np.random.default_rng(18)
    for J, N, C in ((2, N_MAIN, 1), (4, N_MAIN, 1), (2, 1_000_000, 1),
                    (4, 1_000_000, 1), (2, N_MAIN, 64), (4, N_MAIN, 64)):
        model, theta0 = models[J]
        theta = torch.tensor(theta0, device=dev)
        if C > 1:
            theta = theta + 0.1 * torch.tensor(rng.normal(size=(C, len(theta0))),
                                               device=dev)
        data = (bench_data(N, dev, torch.float64) if N == N_MAIN else
                bench_data(N, dev, torch.float64, seed=11, span=10_000.0))
        with plain_route():
            ref = value_and_grad(theta, *data, model)
        fin = fl.pass_inputs(*system("sho" if J == 2 else "sho_mixture", N, C, dev),
                             structured=True)["frev_maps"]
        for rows in SWEEP_ROWS:
            if J == 2:
                ms = cuda_ms(lambda: _build.factor_rev_cuda(*fin, rows), reps=20)
                line = f"factor_rev {ms:.4f} ms"
            else:
                ms4 = cuda_ms(lambda: _build.frev_maps_cuda(*fin, rows), reps=20)
                maps = _tuple(_build.frev_maps_cuda(*fin, rows))
                ms5 = cuda_ms(lambda: _build.frev_states_cuda(*fin, *maps, rows),
                              reps=20)
                line = f"frev_maps {ms4:.4f} ms, frev_states {ms5:.4f} ms"
            with card_block_len("factor_adjoint_block_len", rows), \
                    card_block_len("structured_block_len", rows):
                got = value_and_grad(theta, *data, model)
                rate = steps_per_s(dev, torch.float64, n_steps=10, model=model,
                                   theta0=theta.cpu().numpy(), data=data)
            ev, eg = scaled_err(got[0], ref[0]), scaled_err(got[1], ref[1])
            default = rows == card_len("frev_maps" if J > 2 else "factor_rev", N,
                                       C)
            log("sweep", f"factor adjoint, J = {J}, N = {N}, C = {C}, {rows} rows a "
                f"block (NB = {-(-N // rows)}): {line}; {rate:.2f} evals/s; "
                f"against the plain route value err {ev:.2e}, grad err {eg:.2e}"
                + (" (the default)" if default else ""))


def longdouble_prefix(p, a, U, V, Y):
    """S and F after every row of chain 0 by the factor and lower solve's
    row recursion (``sequential_prefix``'s) in numpy's long double, rounded
    to float64: the sweep's measure of what the float64 recursions lose.
    None where long double is no wider than float64."""
    ld = np.longdouble
    if np.finfo(ld).eps >= np.finfo(np.float64).eps:
        return None
    P, A_, Uu, Vv, Yy = (x[0].cpu().numpy().astype(ld) for x in (p, a, U, V, Y))
    N, J = Uu.shape
    S, F = np.zeros((J, J), ld), np.zeros((J, Yy.shape[1]), ld)
    d, w, z = ld(0), np.zeros(J, ld), np.zeros(Yy.shape[1], ld)
    Ss = np.empty((N, J, J), np.float64)
    Fs = np.empty((N, J, Yy.shape[1]), np.float64)
    for n in range(N):
        pn, un = P[n], Uu[n]
        S = (S + d * np.outer(w, w)) * pn[:, None] * pn[None, :]
        Ss[n] = S
        tmp = S @ un
        d = A_[n] - un @ tmp
        F = pn[:, None] * (F + np.outer(w, z))
        Fs[n] = F
        z = Yy[n] - un @ F
        w = (Vv[n] - tmp) / (d if d > 0 else ld(1))
    return torch.from_numpy(Ss)[None], torch.from_numpy(Fs)[None]


PREFIX_SWEEP = [(J, N, C) for J, N in ((2, N_MAIN), (4, N_MAIN), (8, N_MAIN),
                                       (4, 1_000_000), (8, 1_000_000))
                for C in (1, 64)] + [(16, N_MAIN, 1), (32, N_MAIN, 1)]


def phase_prefix_sweep(dev):
    """The assoc tier's Riccati and Kalman prefixes (K = 1) per rows a
    block on the card, float64: J = 2, 4, 8 at N = 1e5 and J = 4, 8 at
    N = 1e6 with C = 1 and 64, J = 16 and 32 at N = 1e5 with C = 1.  At
    each, the relative error of S and F (of chain 0) against the float64
    row recursion (``row_prefix``) and against the same recursion in long
    double (``longdouble_prefix``), beside the float64 recursion's own
    error against the long double one.  The default length's errors are
    held to LONG_RTOL against both, after every line is logged."""
    worst = {}
    for J, N, C in PREFIX_SWEEP:
        p, a, U, V, Y = prefix_inputs(J, N, C, 1, dev, seed=J)
        fin = (p, a, U, V)
        rows_ref = row_prefix(*first_chain(fin + (Y,)))
        # chain 0's Y depends on C (the data's draws): one truth a (J, N, C)
        began = time.perf_counter()
        truth = longdouble_prefix(*first_chain(fin + (Y,)))
        if truth is not None:
            own = tuple(scaled_err(r, t) for r, t in zip(rows_ref, truth))
            log("sweep", f"prefix, J = {J}, N = {N}, C = {C}: the float64 row "
                f"recursion against the long double one S {own[0]:.2e}, F "
                f"{own[1]:.2e} ({time.perf_counter() - began:.1f} s)")
        for rows in PREFIX_SWEEP_ROWS:
            with card_block_len("kalman_block_len", rows):
                ms_r = cuda_ms(lambda: _build.riccati_prefix_cuda(*fin), reps=3, warmup=1)
                ms_k = cuda_ms(lambda: _build.kalman_prefix_cuda(*fin, Y), reps=3,
                               warmup=1)
                got = _build.kalman_prefix_cuda(*first_chain(fin + (Y,)))
            errs = [scaled_err(g, r) for g, r in zip(got, rows_ref)]
            line = (f"prefix, J = {J}, N = {N}, C = {C}, {rows} rows a block (NB = "
                    f"{-(-N // rows)}): riccati_prefix {ms_r:.4f} ms, kalman_prefix "
                    f"{ms_k:.4f} ms; against the row recursion S {errs[0]:.2e}, F "
                    f"{errs[1]:.2e}")
            if truth is not None:
                errs += [scaled_err(g, t) for g, t in zip(got, truth)]
                line += f"; against the long double S {errs[2]:.2e}, F {errs[3]:.2e}"
            if rows == _build.kalman_block_len(N, J):
                line += " (the default)"
                worst[J, N, C] = max(errs)
            log("sweep", line)
            del got
        del p, a, U, V, Y, fin, rows_ref, truth
        torch.cuda.empty_cache()
    for shape, err in worst.items():
        assert math.isfinite(err) and err < LONG_RTOL, (shape, err)


def solve_maps(J, N, C, dev, seed):
    """The lower solve's matrix-affine elements ``(A, b)`` (K = 1) of
    ``wide_system``: what ``assoc.sweep_fwd`` hands the matrix-affine
    prefix (at J = 8 wide8's terms, the Q = 0.5 one stiff)."""
    p, a, U, V, Y = prefix_inputs(J, N, C, 1, dev, seed)
    W = _build.factor_fwd_cuda(p, a, U, V)[1]
    return assoc.solve_elements(p, U, W, Y)


def longdouble_mat_affine(A, b):
    """x <- A x + b over the rows of chain 0 in numpy's long double, rounded
    to float64 (None where long double is no wider than float64)."""
    ld = np.longdouble
    if np.finfo(ld).eps >= np.finfo(np.float64).eps:
        return None
    A_, b_ = (x[0].cpu().numpy().astype(ld) for x in (A, b))
    x, out = np.zeros(b_.shape[1:], ld), np.empty(b_.shape, np.float64)
    for n in range(b_.shape[0]):
        x = A_[n] @ x + b_[n]
        out[n] = x
    return torch.from_numpy(out)[None]


MAT_AFFINE_SWEEP = [(J, N_MAIN, C) for J in (2, 4, 8) for C in (1, 64)] + [
    (4, 1_000_000, 1), (8, 1_000_000, 1), (16, N_MAIN, 1), (32, 10_000, 1)]
MAT_AFFINE_SWEEP_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
AFFINE_SWEEP = [(8, N_MAIN, 1, 1), (8, N_MAIN, 1, 64), (4, N_MAIN, 1, 1),
                (8, 1_000_000, 1, 1), (8, N_MAIN, 64, 1)]
AFFINE_SWEEP_RUNS = (1, 2, 4, 8, 16, 32)


def phase_affine_sweep(dev):
    """The matrix-affine prefix per rows a block and the diagonal-affine
    prefix per rows a run, on the card, float64.

    * ``mat_affine_prefix`` on the lower solve's elements (K = 1): J = 2, 4,
      8 at N = 1e5 with C = 1 and 64, J = 4, 8 at N = 1e6, J = 16 at
      N = 1e5 and J = 32 at N = 1e4 with one chain; at each block length
      its time and the relative error of chain 0 against the float64 row
      recursion and against the same recursion in long double
      (``longdouble_mat_affine``), beside the float64 recursion's own;
    * ``affine_prefix`` on the rectangular product's (phi, G): J = 8, K = 1
      and 64, J = 4, K = 1 at N = 1e5, J = 8 at N = 1e6, one chain, and
      J = 8, K = 1 with 64 chains; its time and error against the row
      recursion per rows a run.

    The defaults' errors are held to LONG_RTOL against the float64 row
    recursions, after every line is logged."""
    worst = {}
    for J, N, C in MAT_AFFINE_SWEEP:
        A, b = solve_maps(J, N, C, dev, seed=J)
        rows_ref = sequential_prefix("mat_affine_prefix", first_chain((A, b)))[0]
        began = time.perf_counter()
        truth = longdouble_mat_affine(A, b)
        if truth is not None:
            log("sweep", f"mat_affine, J = {J}, N = {N}, C = {C}: the float64 row "
                f"recursion against the long double one {scaled_err(rows_ref, truth):.2e} "
                f"({time.perf_counter() - began:.1f} s)")
        for rows in MAT_AFFINE_SWEEP_ROWS:
            before = _build.LAUNCHES["mat_affine_prefix"]
            _build.mat_affine_prefix_cuda(A, b, False, rows)
            launches = _build.LAUNCHES["mat_affine_prefix"] - before
            ms = cuda_ms(lambda: _build.mat_affine_prefix_cuda(A, b, False, rows),
                         reps=3, warmup=1)
            got = _build.mat_affine_prefix_cuda(*first_chain((A, b)), False, rows)
            errs = [scaled_err(got, rows_ref)]
            line = (f"mat_affine, J = {J}, N = {N}, C = {C}, {rows} rows a block "
                    f"(NB = {-(-N // rows)}, {launches} launches): {ms:.4f} ms; "
                    f"against the row recursion {errs[0]:.2e}")
            if truth is not None:
                errs.append(scaled_err(got, truth))
                line += f", the long double {errs[1]:.2e}"
            if rows == _build.mat_affine_block_len(N, J):
                line += " (the default)"
                worst["mat_affine", J, N, C] = errs[0]
            log("sweep", line)
            del got
        del A, b, rows_ref, truth
        torch.cuda.empty_cache()
    for J, N, C, K in AFFINE_SWEEP:
        t, c, _, _, V, Y = wide_system(J, N, C, K, dev, seed=J)
        G = (V[..., None] * Y[..., None, :]).contiguous()
        phi = scan.transport(t, c)
        rows_ref = prefix_rows(*first_chain((phi, G)), False)
        for run in AFFINE_SWEEP_RUNS:
            ms = cuda_ms(lambda: _build.affine_prefix_cuda(phi, G, False, run),
                         reps=10, warmup=2)
            err = scaled_err(_build.affine_prefix_cuda(
                *first_chain((phi, G)), False, run), rows_ref)
            line = (f"affine_prefix, J = {J}, K = {K}, N = {N}, C = {C}, {run} rows "
                    f"a run ({32 * run} a tile): {ms:.4f} ms; against the row "
                    f"recursion {err:.2e}")
            if run == _build.affine_run_len(N):
                line += " (the default)"
                worst["affine", J, N, C, K] = err
            log("sweep", line)
        del t, c, V, Y, G, phi, rows_ref
        torch.cuda.empty_cache()
    for shape, err in worst.items():
        assert math.isfinite(err) and err < LONG_RTOL, (shape, err)

# ------------------------------------------------------ the fleet sampler

# benchmarks/configs.py config3: an SHO mixture at N = 3e4 under the fleet
# sampler, from its starting point, under a N(0, 2^2) prior on theta
SAMPLER_N = 30_000
THETA3 = np.array([0.0, np.log(5.0), np.log(10.0), -0.5, np.log(3.0)])
FLEET_C = 64
BIG_C = 1024
FLEET_RUN = dict(num_warmup=60, num_samples=40, max_leapfrog=16, chunk_size=50)
SAMPLER_RTOL = 1e-9
SAMPLER_KERNELS = ("kalman_fwd", "solve_rev", "frev_maps", "frev_states")


def config3_data(N, dev):
    """config3's data process: t ~ sort(U(0, 300)) from seed 7, yerr = 0.2,
    y drawn from the true kernel by the port's GaussianProcess.sample with
    a generator seeded 5."""
    t = np.sort(np.random.default_rng(7).uniform(0, 300, N))
    t = torch.tensor(t, device=dev)
    true = (ct.SHOTerm(sigma=1.0, rho=8.0, tau=20.0)
            + ct.SHOTerm(sigma=0.6, rho=2.0, Q=0.3))
    gp = ct.GaussianProcess(true, t=t, yerr=0.2)
    y = gp.sample(torch.Generator(dev).manual_seed(5))
    assert torch.isfinite(y).all()
    return t, y


def config3_logpost(t, y):
    """The batched log-posterior: theta (C, 5) -> (C,)."""

    def logpost(theta):
        ll = ct.gp_loglik(sho_mixture(theta), t, y, yerr=0.2)
        return ll - 0.5 * ((theta / 2.0) ** 2).sum(-1)

    return logpost


class CountedCalls:
    """Counts the calls of ``fn`` and the host seconds spent in them."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, 0, 0.0

    def __call__(self, *args):
        began = time.perf_counter()
        out = self.fn(*args)
        self.seconds += time.perf_counter() - began
        self.calls += 1
        return out


@contextmanager
def patched(module, name, wrapper):
    saved = getattr(module, name)
    setattr(module, name, wrapper)
    try:
        yield wrapper
    finally:
        setattr(module, name, saved)


def segment_carry(logpost, q, eps, log_T, inv_mass=None):
    """A sampler carry at the positions ``q`` (C, 5) on their device, as
    run_hmc builds one, with the step size ``eps``, log T = ``log_T`` and
    the mass ``inv_mass`` (default unit)."""
    dev = q.device
    pot, g = hmc._potential_and_grad(logpost, q)
    eps, log_T = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                  for x in (eps, log_T))
    return hmc._HMCCarry(
        q=q, logp=-pot, g=g, da=adapt.da_init(eps),
        adam=hmc._adam_init(torch.float64, dev), log_T=log_T,
        wf=adapt.welford_init(5, torch.float64, device=dev),
        inv_mass=torch.ones(5, dtype=torch.float64, device=dev)
        if inv_mass is None else inv_mass,
        eps_frozen=eps, rng=torch.Generator(dev))


def sampler_segment_check(smi, t, y):
    """Step 1: 3 iterations of ``_hmc_segment`` (one in warmup with a
    window end and the freeze, two after) on the card and on the CPU's
    plain route, from the same start on the same draws (numpy, seed 11)."""
    C, S = 4, 3
    rng = np.random.default_rng(11)
    q0 = THETA3 + 0.01 * rng.normal(size=(C, 5))
    z, u = rng.normal(size=(S, C, 5)), rng.uniform(size=(S, C))
    first = np.array([True, False, False])
    sched = (first, first, first, first, hmc._halton(S))
    results = {}
    for where, (tt, yy) in (("card", (t, y)), ("cpu", (t.cpu(), y.cpu()))):
        device = tt.device
        logpost = config3_logpost(tt, yy)
        began = time.perf_counter()
        carry = segment_carry(logpost, torch.tensor(q0, device=device), 0.01,
                              math.log(0.08))
        carry, outs = hmc._hmc_segment(
            logpost, carry, sched,
            (torch.tensor(z, device=device), torch.tensor(u, device=device)),
            max_leapfrog=8, target_accept=0.8)
        results[where] = (to_host(carry), to_host(outs))
        log("sampler", f"segment on the {where}: {time.perf_counter() - began:.1f} s "
            f"({smi})")
    (card_carry, card_outs), (cpu_carry, cpu_outs) = results["card"], results["cpu"]
    steps, div = card_outs[3], card_outs[4]
    assert torch.equal(steps, cpu_outs[3]), (steps, cpu_outs[3])
    assert torch.equal(div, cpu_outs[4]), (div, cpu_outs[4])
    u_t = torch.tensor(u)
    assert torch.equal(u_t < card_outs[2], u_t < cpu_outs[2])
    errs = {name: scaled_err(card_outs[i], cpu_outs[i])
            for i, name in enumerate(("q", "logp", "accept_prob"))}

    def leaves(tree):
        return list(tree.values()) if isinstance(tree, dict) else [tree]

    for name in ("da", "log_T", "wf", "inv_mass", "eps_frozen"):
        pairs = zip(leaves(card_carry[name]), leaves(cpu_carry[name]))
        for i, (got, ref) in enumerate(pairs):
            errs[f"{name}[{i}]"] = scaled_err(got, ref)
    worst = max(errs.values())
    log("sampler", f"segment, C = {C}, N = {t.shape[0]}, 3 iterations: leapfrog "
        f"steps {steps.tolist()}, divergences {int(div.sum())}, accepted "
        f"{int((u_t < card_outs[2]).sum())} of {C * S}; card against the CPU route: "
        f"worst error {worst:.2e} (tol {SAMPLER_RTOL:g}; "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f") ({smi})")
    assert worst < SAMPLER_RTOL, errs


def fleet_run(logpost, dev, C, run, **kw):
    """run_hmc over C chains from config3's start (generator seeded 0),
    with the log-density's calls counted and timed by the host."""
    counted = CountedCalls(logpost)
    torch.cuda.synchronize()
    began = time.perf_counter()
    res = run_hmc(counted, torch.tensor(THETA3, device=dev),
                  torch.Generator(dev).manual_seed(0), num_chains=C, **run, **kw)
    torch.cuda.synchronize()
    return res, counted, time.perf_counter() - began


def refuse_retry(chunk, attempt, exc):
    raise RuntimeError(f"chunk {chunk} failed on the card (attempt {attempt}); "
                       "a retry there is a failed phase") from exc


def phase_sampler(dev, smi):
    """The fleet sampler on config3's posterior at N = 3e4, float64:
    ``_hmc_segment`` against the CPU's plain route, ``run_hmc`` with
    checkpoints at C = 64 and its resume, C = 1024, and a profile of two
    post-warmup iterations (kernels K1, K2, K4, K5 through gp_loglik).
    Returns the fleet's evals/s at C = 64."""
    t, y = config3_data(SAMPLER_N, dev)
    logpost = config3_logpost(t, y)
    sampler_segment_check(smi, t, y)

    # step 2: the fleet at C = 64 with checkpoints and a monitor
    total = FLEET_RUN["num_warmup"] + FLEET_RUN["num_samples"]
    chunks = -(-total // FLEET_RUN["chunk_size"])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(f"{tmp}/fleet")
        saves = CountedCalls(mgr.save)
        mgr.save = saves
        snapshots = CountedCalls(chunked.to_host)
        reset_launches()
        with patched(chunked, "to_host", snapshots), \
                sampling_monitor(log_every=0) as (emit, records):
            res, evals, wall = fleet_run(logpost, dev, FLEET_C, FLEET_RUN,
                                         checkpoint=mgr, monitor=emit,
                                         on_retry=refuse_retry)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for name in (*SAMPLER_KERNELS, "factor_rev"):
            assert (launches[name] >= 1) == (name != "factor_rev"), (name, launches)
        assert len(records) == chunks, records
        assert torch.isfinite(res.samples).all() and torch.isfinite(res.log_prob).all()
        rate = evals.calls / wall
        eps, T = res.step_size.item(), res.trajectory_length.item()
        assert math.isfinite(eps) and eps > 0 and math.isfinite(T) and T > 0
        s = summary(res.samples)
        ess = s["ess"].cpu()
        log("sampler", f"fleet C = {FLEET_C}, N = {SAMPLER_N}, {total} iterations "
            f"({FLEET_RUN['num_warmup']} warmup), chunks of {FLEET_RUN['chunk_size']}: "
            f"{wall:.2f} s, {evals.calls - 1} leapfrog steps, {evals.calls} gp_loglik "
            f"evals with the start's ({rate:.2f} "
            f"evals/s inside the sampler, {total / wall:.2f} iterations/s), mean "
            f"accept {res.accept_prob.mean().item():.3f}, divergences "
            f"{int(res.diverging.sum())} of {res.diverging.numel()}, step size "
            f"{eps:.4g}, trajectory {T:.4g}, monitor records "
            f"{[(k, round(v['mean_leapfrogs'], 2)) for k, v in records]} ({smi})")
        log("sampler", f"fleet C = {FLEET_C}: host copies of the carry and outputs "
            f"{snapshots.seconds:.3f} s in {snapshots.calls} calls, checkpoint saves "
            f"{saves.seconds:.3f} s in {saves.calls}, of {wall:.2f} s; ESS "
            f"min {ess.min().item():.1f} mean {ess.mean().item():.1f} over "
            f"{res.samples.shape[1]} draws: min-ESS/s {ess.min().item() / wall:.2f} "
            f"(information only) ({smi})")
        log("sampler", f"fleet C = {FLEET_C}: launches {launches}, per gp_loglik eval "
            + ", ".join(f"{k} {launches[k] / evals.calls:.2f}" for k in SAMPLER_KERNELS)
            + f" ({smi})")

        # step 3: the same run stopped after its first chunk and resumed
        class Killed(Exception):
            pass

        def stop(step, stats):
            raise Killed

        resume = CheckpointManager(f"{tmp}/resume")
        try:
            fleet_run(logpost, dev, FLEET_C, FLEET_RUN, checkpoint=resume,
                      monitor=stop, on_retry=refuse_retry)
            raise AssertionError("the run was not stopped")
        except Killed:
            pass
        assert resume.latest_step() == 0
        again, _, wall2 = fleet_run(logpost, dev, FLEET_C, FLEET_RUN,
                                    checkpoint=CheckpointManager(f"{tmp}/resume"),
                                    on_retry=refuse_retry)
        same = {name: torch.equal(getattr(again, name), getattr(res, name))
                for name in res._fields}
        log("sampler", f"resume after chunk 1 of {chunks}: bitwise equal to the run "
            f"without the stop: {same} (resumed part {wall2:.2f} s) ({smi})")
        assert all(same.values()), same

    # step 4: the README's chain count
    torch.cuda.reset_peak_memory_stats()
    big, evals, wall = fleet_run(logpost, dev, BIG_C,
                                 dict(num_warmup=5, num_samples=5, max_leapfrog=8),
                                 on_retry=refuse_retry)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert torch.isfinite(big.samples).all() and torch.isfinite(big.log_prob).all()
    log("sampler", f"fleet C = {BIG_C}, N = {SAMPLER_N}, 10 iterations: {wall:.2f} s, "
        f"{evals.calls} gp_loglik evals with the start's ({evals.calls / wall:.3f} evals/s, "
        f"{BIG_C * evals.calls / wall:.1f} chain-evals/s, {10 / wall:.3f} "
        f"iterations/s), peak device memory {peak:.2f} GiB ({smi})")

    # step 5: two post-warmup iterations at C = 64, profiled
    # a carry at the fleet's last draws, with its adapted step and mass
    carry = segment_carry(logpost, res.samples[:, -1].contiguous(), res.step_size,
                          torch.log(res.trajectory_length), res.inv_mass)
    sched = tuple(np.zeros(2, bool) for _ in range(4)) + (hmc._halton(2) + 0.5,)
    gen = torch.Generator(dev).manual_seed(1)
    draws = (torch.randn((2, FLEET_C, 5), generator=gen, device=dev, dtype=torch.float64),
             torch.rand((2, FLEET_C), generator=gen, device=dev, dtype=torch.float64))

    def two_iterations():
        return hmc._hmc_segment(logpost, carry, sched, draws, max_leapfrog=16,
                                target_accept=0.8)

    steps = int(two_iterations()[1][3].sum())
    prof = profile_calls(two_iterations, 4, n=1)
    one = profile_calls(lambda: hmc._potential_and_grad(logpost, carry.q), 4, n=steps)
    # the host's time outside the value and gradient: each of them waited
    # for, so that the one host read of an iteration finds the card idle
    walls, plain = {}, hmc._potential_and_grad
    for waited in (False, True):
        def value_and_gradient(*args, _waited=waited):
            out = plain(*args)
            if _waited:
                torch.cuda.synchronize()
            return out

        grads = CountedCalls(value_and_gradient)
        with patched(hmc, "_potential_and_grad", grads):
            torch.cuda.synchronize()
            began = time.perf_counter()
            two_iterations()
            torch.cuda.synchronize()
            walls[waited] = (time.perf_counter() - began, grads.seconds)
        assert grads.calls == steps
    host_ms = 1e3 * (walls[True][0] - walls[True][1]) / steps
    if prof is None or one is None:
        log("sampler", "profile: no device events in the trace: not measured; host "
            f"ms per leapfrog step outside gp_loglik {host_ms:.3f} ({smi})")
        return rate, res.samples[:, -1]
    per_step = prof["kernels_per_eval"] / steps
    gp_per_step = one["kernels_per_eval"]
    own_ms = (prof["busy_ms"] - steps * one["busy_ms"]) / steps
    log("sampler", f"profile, C = {FLEET_C}, 2 post-warmup iterations, {steps} "
        f"leapfrog steps: {prof['kernels_per_eval']:.0f} device kernels "
        f"({per_step:.1f} per step: gp_loglik's value and gradient {gp_per_step:.1f}, "
        f"the sampler's own {per_step - gp_per_step:.1f}), device busy "
        f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span (idle share "
        f"{prof['idle_share']:.3f}, under the profiler; the sampler's own "
        f"{own_ms:.4f} ms per step); one value and gradient alone: device busy "
        f"{one['busy_ms']:.3f} ms, idle share {one['idle_share']:.3f} ({smi})")
    log("sampler", f"without the profiler: {1e3 * walls[False][0] / steps:.3f} ms "
        f"per leapfrog step; with each value and gradient waited for "
        f"{1e3 * walls[True][0] / steps:.3f}, of which {host_ms:.3f} ms on the host "
        f"outside gp_loglik's value and gradient ({smi})")
    top = sorted(one["by_name"].items(), key=lambda kv: -kv[1][1])[:8]
    log("sampler", f"one value and gradient at C = {FLEET_C}, N = {SAMPLER_N}: "
        "device time by kernel (top 8): " + "; ".join(
            f"{k} x{c:.0f} {ms:.4f} ms" for k, (c, ms) in top) + f" ({smi})")
    return rate, res.samples[:, -1]


# ------------------------------------------------------------------ NUTS

# benchmarks/configs.py config2 (:121): a RotationTerm at N = 1e3 (t ~
# sort(U(0, 50)), seed 123, yerr 0.1; a N(0, 2^2) prior on theta), MAP by
# L-BFGS, then 4 chains of NUTS at max_depth 8; config4 (:242): Matern32Term
# + SHOTerm at N = 400 (t ~ sort(U(0, 40)), seed 99, yerr 0.15; a N(PRIOR4,
# 1) prior), MAP from the prior's mean, 4 chains at max_depth 8.  y is drawn
# by the port's GaussianProcess.sample from a CPU generator (seeds 11 and
# 21), so the card and the CPU worker hold the same data.  The runs are cut
# from 500 + 500 and 400 + 400 transitions to fit the smoke test, config2's
# chunks from 100 to 60 (two chunks: the resume after the first reruns 20
# transitions).
NUTS_C, NUTS_DEPTH = 4, 8
# cut from 50 + 30 in chunks of 60 to keep the script inside its 1200 s
# once the groups phase joined it: two chunks still, so the resume after
# the first is tested
CONFIG2_RUN = dict(num_warmup=30, num_samples=20, chunk_size=30)
# cut from 40 + 20 to keep the script inside its 1200 s once the groups
# phase repeated it over a chain group
CONFIG4_RUN = dict(num_warmup=30, num_samples=10)
THETA2 = np.array([0.0, np.log(3.0), np.log(1.5), 0.0, 0.0])
PRIOR4 = np.log([1.0, 1.0, 1.0, 6.0, 8.0])
# the transitions held against the CPU: from near config2's true kernel,
# each chain with its own step size (trees of 1 to a few tens of leaves)
NUTS_STEPS = 5
NUTS_Q0 = np.log([1.0, 3.5, 2.0, 1.0, 0.3 / 0.7])
NUTS_EPS = np.array([0.03, 0.05, 0.08, 0.12])
# config3's posterior (phase_sampler's) as a NUTS fleet; 40 warmup
# transitions, since with 16 the last fast window of the schedule is one
# transition and freezes each step size near ten times the adapted one
# (mean accept in chip runs: 0.002 with 16, 0.60 with 32, 0.82 with 40);
# max_depth cut from 6 to 5 for the script's time: the fleet took
# 53.65 evaluations a transition for its chains' mean 16.52 leapfrog steps
NUTS_FLEET_C, NUTS_FLEET_DEPTH = 64, 5
NUTS_FLEET_RUN = dict(num_warmup=40, num_samples=6)


def cpu64(*values):
    return tuple(torch.tensor(v, dtype=torch.float64) for v in values)


def config2_data():
    """config2's data on the CPU: (t, y)."""
    t, = cpu64(np.sort(np.random.default_rng(123).uniform(0, 50, 1000)))
    true = ct.RotationTerm(**dict(zip(("sigma", "period", "Q0", "dQ", "f"),
                                      cpu64(1.0, 3.5, 2.0, 1.0, 0.3))))
    y = ct.GaussianProcess(true, t=t, yerr=0.1, device="cpu").sample(
        torch.Generator().manual_seed(11))
    return t, y


def config2_logpost(t, y):
    """config2's batched log-posterior: theta (C, 5) = log[sigma, period,
    Q0, dQ] and logit f -> (C,)."""

    def logpost(theta):
        e = theta[:, :4].exp()
        k = ct.RotationTerm(sigma=e[:, 0], period=e[:, 1], Q0=e[:, 2], dQ=e[:, 3],
                            f=torch.sigmoid(theta[:, 4]))
        return ct.gp_loglik(k, t, y, yerr=0.1) - 0.5 * ((theta / 2.0) ** 2).sum(-1)

    return logpost


def config4_data():
    """config4's data on the CPU: (t, y)."""
    t, = cpu64(np.sort(np.random.default_rng(99).uniform(0, 40, 400)))
    s1, r1, s2, r2, tau = cpu64(0.8, 0.9, 1.0, 8.0, 12.0)
    true = ct.Matern32Term(sigma=s1, rho=r1) + ct.SHOTerm(sigma=s2, rho=r2, tau=tau)
    y = ct.GaussianProcess(true, t=t, yerr=0.15, device="cpu").sample(
        torch.Generator().manual_seed(21))
    return t, y


def config4_kernel(theta):
    """config4's model of theta (C, 5) = log[sigma, rho] of the Matern-3/2
    term and log[sigma, rho, tau] of the SHOTerm (J = 4)."""
    e = theta.exp()
    return ct.Matern32Term(sigma=e[:, 0], rho=e[:, 1]) + ct.SHOTerm(
        sigma=e[:, 2], rho=e[:, 3], tau=e[:, 4])


def config4_logpost(t, y):
    """config4's batched log-posterior: theta (C, 5) -> (C,), the prior
    N(PRIOR4, I)."""
    mu = torch.tensor(PRIOR4, device=t.device)

    def logpost(theta):
        return (ct.gp_loglik(config4_kernel(theta), t, y, yerr=0.15)
                - 0.5 * ((theta - mu) ** 2).sum(-1))

    return logpost


def nuts_transitions(t, y):
    """NUTS_STEPS transitions of config2's posterior on t's device (C = 4,
    max_depth 8, a unit metric), from NUTS_Q0 with the step sizes NUTS_EPS,
    on draws from numpy (seed 11): per transition (q, logp, accept_prob,
    energy, num_steps, diverging, turning) as numpy, and the kernel's
    counts."""
    dev = t.device
    logpost = config2_logpost(t, y)
    rng = np.random.default_rng(11)
    q = torch.tensor(NUTS_Q0 + 0.01 * rng.normal(size=(NUTS_C, 5)), device=dev)
    eps = torch.tensor(NUTS_EPS, device=dev)
    inv_mass = torch.ones((NUTS_C, 5), dtype=torch.float64, device=dev)
    pot_grad, rows, counts = None, [], {}
    for _ in range(NUTS_STEPS):
        draws = nuts.NUTSDraws(*(torch.tensor(x, device=dev) for x in (
            rng.normal(size=(NUTS_C, 5)),
            rng.choice([-1.0, 1.0], size=(NUTS_C, NUTS_DEPTH)),
            rng.uniform(size=(NUTS_C, 2**NUTS_DEPTH - 1)),
            rng.uniform(size=(NUTS_C, NUTS_DEPTH)))))
        q, logp, info, g = nuts.nuts_kernel(logpost, q, draws, eps, inv_mass,
                                            max_depth=NUTS_DEPTH, pot_and_grad=pot_grad,
                                            counts=counts)
        pot_grad = (-logp, g)
        rows.append(as_numpy((q, logp, info.accept_prob, info.energy,
                              info.num_steps, info.diverging, info.turning)))
    return rows, counts


def nuts_references():
    """:func:`nuts_transitions` on the CPU's plain route."""
    return nuts_transitions(*config2_data())


def fleet_evaluations(num_steps, D):
    """The evaluations of the vmapped loops of the JAX package for one
    transition from the chains' leapfrog steps (the start's value and
    gradient given): per doubling the most leaves any chain takes."""
    n = np.asarray(num_steps)[:, None]
    return int(np.clip(n - (2 ** np.arange(D) - 1), 0, 2 ** np.arange(D)).max(0).sum())


class TransitionLog:
    """In place of ``sampler.nuts_kernel``: each transition's counts, its
    chains' leapfrog steps and positions (left on the device until the run
    ends)."""

    def __init__(self):
        self.counts, self.steps, self.q = [], [], []

    def __call__(self, *args, **kwargs):
        kwargs["counts"] = counts = {}
        out = nuts.nuts_kernel(*args, **kwargs)
        self.counts.append(counts)
        self.steps.append(out[2].num_steps)
        self.q.append(out[0])
        return out


@contextmanager
def syncs_counted(module, name):
    """Count the calls of ``module.name`` that torch's CUDA sync debug mode
    flags as synchronizing (a host read or wait inside the call)."""
    import warnings

    fn, box = getattr(module, name), {"calls": 0, "syncs": 0}

    def wrapped(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        box["calls"] += 1
        box["syncs"] += sum("synchroniz" in str(w.message) for w in caught)
        return out

    with patched(module, name, wrapped):
        yield box


def nuts_run(logpost, init, dev, C, D, run, **kw):
    """run_nuts over C chains at max_depth D from ``init`` (generator
    seeded 0), the log-density's calls counted, each transition logged."""
    counted, transitions = CountedCalls(logpost), TransitionLog()
    with patched(sampler, "nuts_kernel", transitions):
        torch.cuda.synchronize()
        began = time.perf_counter()
        res = run_nuts(counted, torch.as_tensor(init, device=dev),
                       torch.Generator(dev).manual_seed(0), num_chains=C,
                       max_depth=D, **run, **kw)
        torch.cuda.synchronize()
    return res, counted, transitions, time.perf_counter() - began


def report_nuts_run(label, res, counted, transitions, wall, D, launches, smi):
    """Log a run's rates, tree sizes, host reads, adaptation and ESS, and
    hold each transition's evaluations to the vmapped loops' count."""
    steps = torch.stack(transitions.steps).cpu().numpy()  # (T, C)
    evals = np.array([c["evaluations"] for c in transitions.counts])
    reads = np.array([c["host_reads"] for c in transitions.counts])
    doublings = np.array([c["doublings"] for c in transitions.counts])
    want = np.array([fleet_evaluations(s, D) for s in steps])
    assert np.array_equal(evals, want), (evals, want)
    assert np.all(reads <= evals + doublings), (reads, evals, doublings)
    T = len(evals)
    assert torch.isfinite(res.samples).all() and torch.isfinite(res.log_prob).all()
    eps = res.step_size.cpu().numpy()
    assert np.all(np.isfinite(eps) & (eps > 0)), eps
    s = summary(res.samples)
    ess, rhat = s["ess"].cpu(), s["rhat"].cpu()
    log("nuts", f"{label}: {T} transitions in {wall:.2f} s, {counted.calls} "
        f"gp_loglik evals (the start's and the step-size search's included): "
        f"{counted.calls / wall:.2f} evals/s, {T / wall:.2f} transitions/s; leapfrog "
        f"steps a chain and transition mean {steps.mean():.2f}, max {steps.max()}; "
        f"the fleet's evaluations a transition {evals.mean():.2f} (equal to the "
        f"vmapped loops' count in every transition); host reads a transition "
        f"{reads.mean():.2f} (max {reads.max()}, doublings {doublings.mean():.2f}) "
        f"({smi})")
    log("nuts", f"{label}: draws {tuple(res.samples.shape)}, mean accept "
        f"{res.accept_prob.mean().item():.3f}, divergences {int(res.diverging.sum())} "
        f"of {res.diverging.numel()}, step sizes {np.array2string(eps, precision=4)}; "
        f"ESS min {ess.min().item():.1f} mean {ess.mean().item():.1f}, min-ESS/s "
        f"{ess.min().item() / wall:.2f}, split R-hat max {rhat.max().item():.3f}; "
        "launches per eval " + ", ".join(
            f"{k} {launches[k] / counted.calls:.2f}" for k in SAMPLER_KERNELS)
        + f" ({smi})")
    for k in SAMPLER_KERNELS:
        assert launches[k] >= 1, (label, k, launches)


def phase_nuts(dev, smi, nuts_refs, hmc_rate):
    """NUTS on the card (kernels K1, K2, K4, K5 through gp_loglik, J = 4):
    five transitions of config2's posterior against the CPU's plain route
    (1e-9; steps, divergences and U-turns equal), with the synchronizing
    calls inside gp_loglik's value and gradient counted; config2 by MAP
    then run_nuts in chunks with a checkpoint and its bitwise resume;
    config4 likewise, shorter; config3's posterior as a fleet of 64 chains
    beside ``hmc_rate``, run_hmc's evals/s on the same posterior and chains
    in :func:`phase_sampler`; a profile of two of the fleet's transitions.
    Returns config4's run (its start, result, and each transition's leapfrog
    steps and positions) for :func:`phase_groups`."""
    began = time.perf_counter()

    def lap(step):
        nonlocal began
        log("time", f"phase_nuts {step}: {time.perf_counter() - began:.1f} s")
        began = time.perf_counter()

    # step 1: transitions against the CPU
    t2, y2 = (x.to(dev) for x in config2_data())
    with syncs_counted(nuts, "_potential_and_grad") as syncs:
        card_rows, counts = nuts_transitions(t2, y2)
    cpu_rows, _ = nuts_refs.get()
    worst = 0.0
    for i, (card, cpu) in enumerate(zip(card_rows, cpu_rows)):
        for name, got, ref in zip(("num_steps", "diverging", "turning"), card[4:], cpu[4:]):
            assert np.array_equal(got, ref), (i, name, got, ref)
        for got, ref in zip(card[:4], cpu[:4]):
            worst = max(worst, scaled_err(torch.from_numpy(got), torch.from_numpy(ref)))
    log("nuts", f"config2, C = {NUTS_C}, max_depth {NUTS_DEPTH}, {NUTS_STEPS} "
        f"transitions: leapfrog steps {[r[4].tolist() for r in card_rows]}, "
        f"diverging {sum(int(r[5].sum()) for r in card_rows)}, U-turns "
        f"{sum(int(r[6].sum()) for r in card_rows)}; card against the CPU route: "
        f"worst error {worst:.2e} (tol {SAMPLER_RTOL:g}), integers equal; "
        f"{counts['evaluations']} evaluations, {counts['host_reads']} host reads, "
        f"{counts['doublings']} doublings; synchronizing calls inside gp_loglik's "
        f"value and gradient: {syncs['syncs']} in {syncs['calls']} ({smi})")
    assert worst < SAMPLER_RTOL, worst
    lap("transitions against the CPU")

    # step 2: config2, MAP then run_nuts in chunks, stopped and resumed
    logpost2 = config2_logpost(t2, y2)
    map_began = time.perf_counter()
    fit = fit_map(logpost2, torch.tensor(THETA2, device=dev), num_steps=300)
    map_s = time.perf_counter() - map_began
    assert torch.isfinite(fit.params).all() and math.isfinite(fit.log_prob.item())
    log("nuts", f"config2: MAP by L-BFGS, 300 steps, {map_s:.2f} s, log posterior "
        f"{fit.log_prob.item():.3f} at {np.round(fit.params.cpu().numpy(), 4).tolist()} "
        f"({smi})")
    total = CONFIG2_RUN["num_warmup"] + CONFIG2_RUN["num_samples"]
    chunks = -(-total // CONFIG2_RUN["chunk_size"])
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        full = CheckpointManager(f"{tmp}/full", max_to_keep=chunks)
        with sampling_monitor(log_every=0) as (emit, records):
            res, evals, transitions, wall = nuts_run(
                logpost2, fit.params, dev, NUTS_C, NUTS_DEPTH, CONFIG2_RUN,
                checkpoint=full, monitor=emit, on_retry=refuse_retry)
        assert len(records) == chunks, records
        report_nuts_run(f"config2, N = 1000, C = {NUTS_C}, max_depth {NUTS_DEPTH}, "
                        f"{CONFIG2_RUN}", res, evals, transitions, wall, NUTS_DEPTH,
                        dict(_build.LAUNCHES), smi)
        # a run stopped after its first chunk leaves that chunk's checkpoint,
        # the one this run wrote: resume from a copy of it
        resume = CheckpointManager(f"{tmp}/resume")
        shutil.copy(full._path(0), resume._path(0))
        again, _, _, wall2 = nuts_run(logpost2, fit.params, dev, NUTS_C, NUTS_DEPTH,
                                      CONFIG2_RUN, checkpoint=resume,
                                      on_retry=refuse_retry)
        same = {name: torch.equal(getattr(again, name), getattr(res, name))
                for name in res._fields}
        log("nuts", f"config2: resume after chunk 1 of {chunks}: bitwise equal to "
            f"the run without the stop: {same} (resumed part {wall2:.2f} s) ({smi})")
        assert all(same.values()), same
    lap("config2 with its resume")

    # step 3: config4
    t4, y4 = (x.to(dev) for x in config4_data())
    logpost4 = config4_logpost(t4, y4)
    fit4 = fit_map(logpost4, torch.tensor(PRIOR4, device=dev), num_steps=300)
    assert torch.isfinite(fit4.params).all()
    reset_launches()
    res4, evals4, transitions4, wall4 = nuts_run(logpost4, fit4.params, dev, NUTS_C,
                                                 NUTS_DEPTH, CONFIG4_RUN,
                                                 on_retry=refuse_retry)
    report_nuts_run(f"config4, N = 400, C = {NUTS_C}, max_depth {NUTS_DEPTH}, "
                    f"{CONFIG4_RUN}", res4, evals4, transitions4, wall4, NUTS_DEPTH,
                    dict(_build.LAUNCHES), smi)
    # what phase_groups holds the chain group's run against
    config4_run = {"init": fit4.params.cpu().numpy(), "wall": wall4,
                   "evals": evals4.calls, "result": as_numpy(res4._asdict()),
                   "steps": torch.stack(transitions4.steps).cpu().numpy(),
                   "q": torch.stack(transitions4.q).cpu().numpy()}
    lap("config4")

    # step 4: config3's posterior as a fleet, beside run_hmc
    t3, y3 = config3_data(SAMPLER_N, dev)
    logpost3 = config3_logpost(t3, y3)
    reset_launches()
    fleet, evals3, transitions3, wall3 = nuts_run(
        logpost3, THETA3, dev, NUTS_FLEET_C, NUTS_FLEET_DEPTH, NUTS_FLEET_RUN,
        on_retry=refuse_retry)
    report_nuts_run(f"fleet, config3's posterior, N = {SAMPLER_N}, C = {NUTS_FLEET_C}, "
                    f"max_depth {NUTS_FLEET_DEPTH}, {NUTS_FLEET_RUN}", fleet, evals3,
                    transitions3, wall3, NUTS_FLEET_DEPTH, dict(_build.LAUNCHES), smi)
    log("nuts", f"fleet C = {NUTS_FLEET_C}: run_nuts {evals3.calls / wall3:.2f} "
        f"evals/s beside run_hmc's {hmc_rate:.2f} in this process (phase_sampler's "
        f"fleet, {FLEET_RUN}) ({smi})")
    lap("fleet")

    # step 5: two of the fleet's transitions, profiled
    q = fleet.samples[:, -1].contiguous()
    eps, inv_mass = fleet.step_size, fleet.inv_mass
    pot_grad = hmc._potential_and_grad(logpost3, q)
    gen = torch.Generator(dev).manual_seed(1)
    draws = [nuts.draw_nuts(gen, NUTS_FLEET_C, 5, NUTS_FLEET_DEPTH) for _ in range(2)]

    def two_transitions(counts=None):
        qq, pg = q, pot_grad
        for d in draws:
            qq, logp, _, g = nuts.nuts_kernel(logpost3, qq, d, eps, inv_mass,
                                              max_depth=NUTS_FLEET_DEPTH,
                                              pot_and_grad=pg, counts=counts)
            pg = (-logp, g)
        return qq

    # the host's time outside the value and gradient, then the profile
    counts, walls, plain = {}, {}, nuts._potential_and_grad
    for waited in (False, True):
        def value_and_gradient(*args, _waited=waited):
            out = plain(*args)
            if _waited:
                torch.cuda.synchronize()
            return out

        grads = CountedCalls(value_and_gradient)
        with patched(nuts, "_potential_and_grad", grads):
            torch.cuda.synchronize()
            run_began = time.perf_counter()
            two_transitions(None if waited else counts)
            torch.cuda.synchronize()
            walls[waited] = (time.perf_counter() - run_began, grads.seconds)
        steps = counts["evaluations"]
        assert grads.calls == steps
    host_ms = 1e3 * (walls[True][0] - walls[True][1]) / steps
    # the trace of the device's kernels alone: tracing the host's ops too
    # took 49.5 s against 25.9 s for these some 85000 kernels (H100 80GB
    # HBM3, 700 W)
    prof = profile_calls(two_transitions, 4, n=1, host_ops=False)
    one = profile_calls(lambda: hmc._potential_and_grad(logpost3, q), 4, n=3,
                        host_ops=False)
    lap("profile")
    log("nuts", f"profile, C = {NUTS_FLEET_C}, 2 transitions, {steps} leapfrog steps "
        f"of the fleet, {counts['host_reads']} host reads: without the profiler "
        f"{1e3 * walls[False][0] / steps:.3f} ms a step; with each value and "
        f"gradient waited for {1e3 * walls[True][0] / steps:.3f}, of which "
        f"{host_ms:.3f} ms on the host outside gp_loglik's value and gradient ({smi})")
    if prof is None or one is None:
        log("nuts", f"profile: no device events in the trace: not measured ({smi})")
        return config4_run
    per_step = prof["kernels_per_eval"] / steps
    gp_per_step = one["kernels_per_eval"]
    own_ms = (prof["busy_ms"] - steps * one["busy_ms"]) / steps
    log("nuts", f"profile, C = {NUTS_FLEET_C}: {prof['kernels_per_eval']:.0f} device "
        f"kernels ({per_step:.1f} a step: gp_loglik's value and gradient "
        f"{gp_per_step:.1f}, NUTS's own {per_step - gp_per_step:.1f}), device busy "
        f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span (idle share "
        f"{prof['idle_share']:.3f}, under the profiler; NUTS's own {own_ms:.4f} ms "
        f"a step); one value and gradient alone: busy {one['busy_ms']:.3f} ms, idle "
        f"share {one['idle_share']:.3f} ({smi})")
    return config4_run


# ------------------------------------------------------------ the terms

# gp_loglik through the term algebra on bench.py's data at N = 1e5, against
# the CPU's plain route in a worker: a product of two SHOTerms (J = 4, the
# fused path), config2's RotationTerm times an SHOTerm (J = 8, the general
# kernels) and a boxcar convolution of bench.py's SHOTerm (J = 2)
TERMS_N = N_MAIN
TERMS_MODELS = {
    "SHOTerm x SHOTerm (J = 4)": (
        lambda th: sho(th[..., :3]) * ct.SHOTerm(sigma=th[..., 3].exp(),
                                                 rho=th[..., 4].exp(), Q=2.0),
        np.log([1.0, 5.0, 3.0, 0.8, 20.0]),
        ("kalman_fwd", "solve_rev", "frev_maps", "frev_states")),
    "RotationTerm x SHOTerm (J = 8)": (
        lambda th: rotation(th) * ct.SHOTerm(sigma=1.0, rho=30.0, tau=60.0),
        THETA_ROT, ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd")),
    "TermConvolution of an SHOTerm (J = 2)": (
        lambda th: ct.TermConvolution(sho(th), 0.5), THETA0,
        ("kalman_fwd", "solve_rev", "factor_rev")),
}


def terms_references(N):
    """gp_loglik's value and theta-gradient for each of TERMS_MODELS on
    bench.py's data at N rows, the CPU's plain route in float64, and the
    seconds of each."""
    t, y = bench_data(N, "cpu", torch.float64)
    out = {}
    for label, (model, theta, _) in TERMS_MODELS.items():
        began = time.perf_counter()
        v, g = value_and_grad(torch.tensor(theta), t, y, model)
        out[label] = (v.numpy(), g.numpy(), time.perf_counter() - began)
    return out


def phase_terms(dev, smi, terms_refs):
    """gp_loglik's value and gradient through a product, a wider product
    and a convolution on the card, against the CPU's plain route at 1e-9,
    with the kernels each launches."""
    t, y = bench_data(TERMS_N, dev, torch.float64)
    refs = terms_refs.get()
    for label, (model, theta, kernels) in TERMS_MODELS.items():
        theta = torch.tensor(theta, device=dev)
        value_and_grad(theta, t, y, model)
        reset_launches()
        torch.cuda.synchronize()
        began = time.perf_counter()
        v, g = value_and_grad(theta, t, y, model)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - began)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        v_ref, g_ref, cpu_s = refs[label]
        ev = scaled_err(v, torch.from_numpy(v_ref))
        eg = scaled_err(g, torch.from_numpy(g_ref))
        log("terms", f"{label}, N = {TERMS_N}, float64: value and gradient "
            f"{ms:.2f} ms on the card (the CPU route {cpu_s:.1f} s), value err "
            f"{ev:.2e}, grad err {eg:.2e} (tol 1e-9); launches {launches} ({smi})")
        assert ev < 1e-9 and eg < 1e-9, (label, ev, eg)
        for k in kernels:
            assert launches.get(k, 0) >= 1, (label, k, launches)


# ---------------------------------------------- posterior-predictive draws

# (a) the README's quick start at full width, under backend="auto": bench.py's
# data at N = 1e5 with gp_data's M = 1e4 targets, config5's J = 4 mixture at
# THETA4 (32 draws) and wide8 at THETA0 (J = 8, 8 draws), against the CPU
# route in a worker on the same normals (a CPU generator seeded
# PATHWISE_SEED); (c) the posterior-predictive fleet: config3's posterior
# at N = 3e4, one state for each of phase_sampler's last 64 draws, M = 1e3
# targets, 8 draws a chain
PATHWISE_MODELS = {"J=4": (sho_mixture, THETA4, 32), "J=8": (wide8, THETA0, 8)}
PATHWISE_SEED = 3
PATHWISE_RTOL = 1e-9
# The joint prior has no observational diagonal: on this data its pivots
# fall below float64's resolution (ROADMAP C8), and the map from the normals
# to the draws is not determined to 1e-9 on any route, so the draws without
# a jitter are reported.  The card is held to the CPU route at 1e-9 on the
# joint prior jittered by the smallest decade at which the CPU route's own
# prior draw lies within 1e-10 of a long-double recursion: 1e-7 at J = 4
# (7.6e-11).  At J = 8, whose near-critical Q = 0.5 term amplifies rounding,
# none from 1e-7 to 1e-2 does: 1e-2 is the one within the gate (3.7e-10;
# 1.4e-6 at 1e-7, where the card's own prior draw reads the same 1.4e-6).
# ``pathwise_jitter.py`` takes these readings.
PATHWISE_JITTER = {"J=4": 1e-7, "J=8": 1e-2}
# the kernels of a pathwise draw on each tier (the rectangular products'
# affine_prefix on both)
TIER_KERNELS = {"assoc": ("riccati_prefix", "mat_affine_prefix", "affine_prefix"),
                "scan": ("factor_fwd", "sweep_fwd", "affine_prefix")}
PREDICTIVE_M, PREDICTIVE_DRAWS = 1000, 8


def synced_seconds(fn):
    """``fn()`` and its seconds on the host clock, the card synchronized
    before and after."""
    torch.cuda.synchronize()
    began = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - began


def pathwise_conditional(label, t, y, t_new):
    """The quick start's conditional of model ``label`` on the device of
    ``t``: ``(cond, its number of draws)``."""
    model, theta, draws = PATHWISE_MODELS[label]
    gp = ct.GaussianProcess(model(t.new_tensor(theta)), t, yerr=0.25, mean=0.1)
    return gp.condition(y, t=t_new), draws


def pathwise_references():
    """(a)'s draws of each model on the CPU's plain route, as numpy, without
    and with its jitter, with the seconds of the first and its compute."""
    t, y, t_new, _ = gp_data(N_MAIN)
    out = {}
    for label in PATHWISE_MODELS:
        began = time.perf_counter()
        cond, S = pathwise_conditional(label, *map(torch.tensor, (t, y, t_new)))
        draws, seconds = {}, None
        for reg in (None, PATHWISE_JITTER[label]):
            draws[reg] = cond.sample_pathwise(
                torch.Generator().manual_seed(PATHWISE_SEED), shape=(S,),
                regularize=reg).numpy()
            seconds = seconds or time.perf_counter() - began
        out[label] = (draws, seconds)
    return out


def pathwise_quick_start(dev, smi, refs):
    """(a): sample_pathwise at N = 1e5, M = 1e4 on the card under "auto"
    against the CPU route on the same normals: without a jitter (reported:
    the joint prior's pivots fall below float64's resolution, ROADMAP C8)
    and with the model's PATHWISE_JITTER (held to 1e-9; at J = 4 on both
    tiers).  Returns the J = 4 GP."""
    t, y, t_new, _ = gp_data(N_MAIN)
    t, y, t_new = (torch.tensor(x, device=dev) for x in (t, y, t_new))
    for label in PATHWISE_MODELS:
        jitter = PATHWISE_JITTER[label]
        reset_launches()
        (cond, S), compute_s = synced_seconds(
            lambda: pathwise_conditional(label, t, y, t_new))
        compute_launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        cond.sample_pathwise(torch.Generator(dev).manual_seed(1), shape=(S,))
        reset_launches()
        with count_plain_versions() as plain_calls:
            _, secs = synced_seconds(lambda: cond.sample_pathwise(
                torch.Generator(dev).manual_seed(PATHWISE_SEED), shape=(S,)))
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        log("pathwise", f"{label}, N = {N_MAIN}, M = {t_new.shape[0]}, float64, "
            f"auto: sample_pathwise(shape=({S},)) {1e3 * secs:.2f} ms with a "
            f"generator on the card ({S / secs:.1f} draws/s); compute "
            f"{1e3 * compute_s:.2f} ms; launches a call {launches} (compute's "
            f"{compute_launches}); plain versions {plain_calls} ({smi})")
        assert not any(plain_calls.values()), plain_calls
        joint_tier = dispatch.backend(dev, 1, N_MAIN + t_new.shape[0],
                                      cond.gp.state.c.shape[-1], torch.float64)
        for k in TIER_KERNELS[joint_tier]:
            assert launches.get(k, 0) >= 1, (label, k, launches)
        # the CPU route's normals: a CPU generator
        ref_draws, cpu_s = refs.get()[label]
        tiers = ("auto", "scan") if label == "J=4" else ("auto",)
        for name in tiers:
            for reg in (None, jitter):
                with tier(name):
                    draws, secs = synced_seconds(lambda: cond.sample_pathwise(
                        torch.Generator().manual_seed(PATHWISE_SEED), shape=(S,),
                        regularize=reg))
                assert draws.device == dev and tuple(draws.shape) == (S, t_new.shape[0])
                assert torch.isfinite(draws).all()
                err = scaled_err(draws, torch.from_numpy(ref_draws[reg]))
                gate = f"tol {PATHWISE_RTOL:g}" if reg else "not gated: ROADMAP C8"
                log("pathwise", f"{label}, {name}, regularize={reg}: {1e3 * secs:.2f} "
                    f"ms with a CPU generator; against the CPU route ({cpu_s:.1f} s) "
                    f"{err:.2e} ({gate}) ({smi})")
                if reg is not None:
                    assert err < PATHWISE_RTOL, (label, name, err)
        if label == "J=4":
            assert compute_launches.get("riccati_prefix", 0) >= 1, compute_launches
            gp4 = cond.gp
    return gp4


def pathwise_exact_law(dev, smi):
    """(b): the Jacobian A of _pathwise_transform of a component
    conditional (N = 300, M = 20) on the card: A A^T equals covariance, the
    map at zero noise the mean.  Returns the small problem's data."""
    rng = np.random.default_rng(11)
    N, M = 300, 20
    t = np.sort(rng.uniform(0, 30, N))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=N)
    t_new = np.linspace(-1.0, 31.0, M)
    kernel = sho_mixture(torch.tensor(THETA4, device=dev))
    gp = ct.GaussianProcess(kernel, torch.tensor(t, device=dev), yerr=0.25, mean=0.1)
    cond = gp.condition(y, t=t_new, kernel=kernel.terms[0])

    def draw(noise):
        z, zc, eps = noise[: N + M], noise[N + M: 2 * N + M], noise[2 * N + M:]
        return cond._pathwise_transform(z, eps, z_comp=zc)

    zero = torch.zeros(3 * N + M, dtype=torch.float64, device=dev)
    reset_launches()
    A, secs = synced_seconds(lambda: torch.autograd.functional.jacobian(draw, zero))
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    mean, cov = cond.mean, cond.covariance
    at_zero = draw(zero)
    cov_err = ((A @ A.T - cov).abs() - 1e-6 * cov.abs()).max().item()
    mean_err = ((at_zero - mean).abs() - 1e-7 * mean.abs()).max().item()
    log("pathwise", f"exact law, component conditional, N = {N}, M = {M}, on the "
        f"card: Jacobian {tuple(A.shape)} in {secs:.2f} s, launches {launches}; "
        f"max(|A A^T - cov| - 1e-6 |cov|) = {cov_err:.2e} (tol 1e-8), "
        f"max(|transform(0) - mean| - 1e-7 |mean|) = {mean_err:.2e} (tol 1e-9) ({smi})")
    assert A.device == dev and cov_err <= 1e-8 and mean_err <= 1e-9
    assert launches.get("sweep_bwd", 0) >= 1, launches
    return t, y, t_new


def pathwise_fleet(dev, smi, fleet_theta):
    """(c): one gp_compute over 64 posterior draws of config3 and one
    gp_sample_conditional, (64, 8, 1000), against chains 0 and 63's
    one-system calls on the card (1e-12)."""
    from celerite2_torch import gp as tgp

    t, y = config3_data(SAMPLER_N, dev)
    theta = fleet_theta.to(dev)
    C, M, S = theta.shape[0], PREDICTIVE_M, PREDICTIVE_DRAWS
    t_new = torch.linspace(0.0, 300.0, M, dtype=torch.float64, device=dev)
    kernel = sho_mixture(theta)
    state, compute_s = synced_seconds(lambda: ct.gp_compute(kernel, t, yerr=0.2))
    ct.gp_sample_conditional(state, kernel, y, t_new, torch.Generator(dev),
                             shape=(S,))
    reset_launches()
    draws, secs = synced_seconds(lambda: ct.gp_sample_conditional(
        state, kernel, y, t_new, torch.Generator(dev).manual_seed(7), shape=(S,)))
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    assert tuple(draws.shape) == (C, S, M) and torch.isfinite(draws).all()
    assert bool(state.ok.all()), "a posterior draw's system is not positive definite"
    N = t.shape[0]
    for k in TIER_KERNELS[dispatch.backend(dev, C, N + M, 4, torch.float64)]:
        assert launches.get(k, 0) >= 1, (k, launches)
    # the same normals, drawn in gp_sample_conditional's order
    g = torch.Generator(dev).manual_seed(7)
    z = torch.randn(C, S, N + M, generator=g, dtype=torch.float64, device=dev)
    eps = torch.randn(C, S, N, generator=g, dtype=torch.float64, device=dev)
    errs = {}
    for i in (0, C - 1):
        one_kernel = sho_mixture(theta[i])
        one = ct.gp_compute(one_kernel, t, yerr=0.2)
        want = tgp._pathwise_core(one, one_kernel, y, t_new, z[i], eps[i])
        errs[i] = scaled_err(draws[i], want)
    log("pathwise", f"fleet: config3's posterior, C = {C}, N = {N}, M = {M}, "
        f"shape ({S},): gp_compute {1e3 * compute_s:.2f} ms, gp_sample_conditional "
        f"{1e3 * secs:.2f} ms ({C * S / secs:.1f} draws/s), launches a call "
        f"{launches}; chains {list(errs)} against their one-system calls "
        + ", ".join(f"{e:.2e}" for e in errs.values()) + f" (tol 1e-12) ({smi})")
    assert max(errs.values()) < 1e-12, errs


def pathwise_adapters(dev, smi, gp4, small):
    """(d): CeleriteNormal, LoglikCore (the fused path at J = 4) and
    ConditionalMomentsCore on the card against the calls they wrap."""
    from celerite2_torch import pymc_support as pm

    t, y = gp4.state.t, gp_data(N_MAIN)[1]
    dist = gp4.distribution(torch.Generator(dev).manual_seed(0))
    ys = t.new_tensor(y)
    err = scaled_err(dist.log_prob(ys), gp4.log_likelihood(ys))
    draws = dist.rsample((2,))
    log("pathwise", f"CeleriteNormal (J = 4, N = {N_MAIN}): log_prob against "
        f"log_likelihood {err:.2e}; rsample {tuple(draws.shape)} ({smi})")
    assert err < 1e-12 and tuple(draws.shape) == (2, N_MAIN)
    assert draws.device == dev and torch.isfinite(draws).all()

    core = pm.LoglikCore(pm.make_gp_loglik_fn(sho_mixture, t.cpu().numpy(), y,
                                              yerr=0.25))
    reset_launches()
    value, (grad,) = core.value(THETA4), core.grad(np.asarray(1.0), THETA4)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    want, want_g = value_and_grad(torch.tensor(THETA4, device=dev), t, ys,
                                  sho_mixture)
    ev = scaled_err(torch.from_numpy(np.asarray(value)), want)
    eg = scaled_err(torch.from_numpy(grad), want_g)
    log("pathwise", f"LoglikCore (J = 4, N = {N_MAIN}): value {ev:.2e}, gradient "
        f"{eg:.2e} against gp_loglik (tol 1e-12); launches {launches} ({smi})")
    assert ev < 1e-12 and eg < 1e-12, (ev, eg)
    for k in SAMPLER_KERNELS:
        assert launches.get(k, 0) >= 1, (k, launches)

    t_s, y_s, t_new = small
    moments = pm.ConditionalMomentsCore(sho_mixture, t_s, y_s, t_new=t_new,
                                        yerr=0.25, mean=0.1)
    mu, cov = moments.values(THETA4)
    gp = ct.GaussianProcess(sho_mixture(torch.tensor(THETA4, device=dev)),
                            torch.tensor(t_s, device=dev), yerr=0.25, mean=0.1)
    cond = gp.condition(y_s, t=t_new)
    em = scaled_err(torch.from_numpy(mu), cond.mean)
    ec = scaled_err(torch.from_numpy(cov), cond.covariance)
    log("pathwise", f"ConditionalMomentsCore (N = {len(t_s)}, M = {len(t_new)}): mean "
        f"{em:.2e}, covariance {ec:.2e} against condition() (tol 1e-12) ({smi})")
    assert em < 1e-12 and ec < 1e-12, (em, ec)


# ------------------------------------------------ the sharded paths

# The K6 modes a shard of a sequence split over ranks runs
# (celerite2_torch.parallel): the Riccati and matrix-affine prefixes from an
# incoming state (row 0's element from the row before it, S0 / x0), and each
# chain's total map without the rows' states.  Each is a wrapper of its own
# in ops/_build.py, and each counts its launches under its own key (the
# prefixes' launches from S0 / x0 apart from their zero-start ones).
CARRY_KERNELS = {
    "riccati_prefix:carry": ("riccati_prefix", "celerite2_tpu/ops/planes_engine.py:311"),
    "riccati_total": ("riccati_total", "celerite2_tpu/ops/planes_engine.py:311"),
    "mat_affine_prefix:carry": ("mat_affine_prefix",
                                "celerite2_tpu/ops/planes_engine.py:311"),
    "mat_affine_total": ("mat_affine_total", "celerite2_tpu/ops/planes_engine.py:311"),
}
CARRY_RTOL = 1e-10
# rows a rank of the sharded phase's J = 4 log-likelihood: config5's
# N = 1e6 over four ranks
SHARD_ROWS = 250_000
CARRY_GRID = ((130, None), (1040, None), (1040, 8), (10_000, None), (10_000, 2))


def split_riccati(fin, k, L=None):
    """The Riccati kernels on rows [0, k) and [k, N) of ``fin = (p, a, U,
    V)`` as two shards: the head's total map, the tail's states from the
    head's state (row k - 1 as the row before it, S0 the total's Q), the
    tail's total map; and the plain versions' same."""
    head = tuple(x[:, :k].contiguous() for x in fin)
    tail = tuple(x[:, k:].contiguous() for x in fin)
    prev = tuple(x[:, k - 1].contiguous() for x in fin[1:])
    tot = _build.riccati_total_cuda(*head, L)
    S = _build.riccati_prefix_cuda(*tail, L, prev=prev, S0=tot[1].contiguous())
    tot2 = _build.riccati_total_cuda(*tail, L, prev=prev)
    ptot = pe.riccati_total_plain(*head)
    pS = pe.riccati_prefix_plain(*tail, prev=prev, S0=ptot[1])
    ptot2 = pe.riccati_total_plain(*tail, prev=prev)
    return (tot, S, tot2), (ptot, pS, ptot2)


def split_mat_affine(A, b, k, reverse, L=None):
    """The matrix-affine kernels on rows [0, k) and [k, M) as two shards,
    the first in walk order handing its total map's q on as the second's
    x0: ``(total of the first, F of the second)``, and the plain versions'
    same."""
    lo = tuple(x[:, :k].contiguous() for x in (A, b))
    hi = tuple(x[:, k:].contiguous() for x in (A, b))
    first, second = (hi, lo) if reverse else (lo, hi)
    tot = _build.mat_affine_total_cuda(*first, reverse, L)
    F = _build.mat_affine_prefix_cuda(*second, reverse, L, x0=tot[1].contiguous())
    ptot = pe.mat_affine_total_plain(*first, reverse=reverse)
    pF = pe.mat_affine_prefix_plain(*second, reverse=reverse, x0=ptot[1])
    return (tot, F), (ptot, pF)


def hold_carry(name, got, plain, whole, worst, tol=CARRY_RTOL):
    """The carry modes of one split: each output against the zero-start
    kernels on the whole sequence (``whole``: same structure, None where
    there is none) to ``tol``, and against the plain version to ``tol`` or
    1.5 times the plain version's own distance from the whole, whichever is
    larger (the doubling composes maps of up to N / 2 rows; a total's A and
    R, which the whole does not give, take the tolerance of its Q)."""
    e_self = max((scaled_err(p, w) for p, w in zip(plain, whole) if w is not None),
                 default=0.0)
    for g, p, w in zip(got, plain, whole):
        assert g.shape == p.shape, (name, tuple(g.shape), tuple(p.shape))
        e_plain = scaled_err(g, p)
        e_whole = scaled_err(g, w) if w is not None else 0.0
        assert math.isfinite(e_plain) and e_plain < max(tol, 1.5 * e_self), (
            name, tuple(g.shape), e_plain, e_self)
        assert math.isfinite(e_whole) and e_whole < tol, (name, tuple(g.shape), e_whole)
        worst[name] = tuple(map(max, worst[name], (e_whole, e_plain, e_self)))


def carry_flops(name, C, M, J, D=None, K=1):
    """Operations of one call of a carry mode: per row the rank-one step of
    the blocks' maps (the totals) and of the walk again (the prefixes,
    ``kernel_flops``), and for the matrix-affine family the row's map
    composed into the block's (2 D^3 + 2 D^2 K) and the walk from the value
    entering the block (2 D^2 K); above D = 32 the totals walk the D + K
    columns of [P | q] (2 D^2 (D + K))."""
    D = J if D is None else D
    if name == "riccati_prefix:carry":
        return kernel_flops("riccati_prefix", C, M, J)
    if name == "riccati_total":
        return C * M * 16 * J * J
    if name == "mat_affine_prefix:carry":
        return C * M * (2 * D**3 + 4 * D * D * K if D <= 32 else 2 * D * D * K)
    return C * M * (2 * D**3 + 2 * D * D * K if D <= 32 else 2 * D * D * (D + K))


def phase_carry_kernels(dev):
    """The K6 modes of the sharded paths on the card against their plain
    versions and against the zero-start kernels on the whole sequence,
    float64: a sequence split at row k into two shards (the head's total
    map hands its state on, the tail's prefix starts from it), Riccati at
    J = 1, 2, 4, 8, 16 and matrix-affine on the lower solve's J x J maps
    (K = 1, 5; and the upper solve's in reverse) and on contracting maps of D = 9, 25,
    64, 81, at N = 130, 1040 and 1e4 (also in blocks of 8 and 2 rows: many
    groups, more groups than a scan thread's run), C = 3 and 1, to 1e-10;
    at N = 1e5, C = 1, J = 4, 8 to 1e-9; float32 (J = 2, 4, 8, N = 1040,
    blocks of 8) within max(1e-4, 2 x the float32 plain version's error)
    of the float64 kernels.  Returns the largest absolute errors of the
    four modes at the sharded loglik's J = 4 shapes."""
    worst = {name: (0.0, 0.0, 0.0) for name in CARRY_KERNELS}
    rng = np.random.default_rng(11)

    def contracting(D, M, C, scale):
        A = torch.tensor(rng.normal(size=(C, M, D, D)) * scale / math.sqrt(D), device=dev)
        return A, torch.tensor(rng.normal(size=(C, M, D, 1)), device=dev)

    for J in (1, 2, 4, 8, 16):
        for N, L in CARRY_GRID:
            if J >= 8 and L is not None and L < 8:
                continue
            for C in (3, 1):
                t, c, a, U, V, Y5 = wide_system(J, N, C, 5, dev, seed=J + N + C)
                p = scan.transport(t, c)
                fin = (p, a, U, V)
                k = N // 3 + 1
                S_all = _build.riccati_prefix_cuda(*fin, L)
                (tot, S, tot2), (ptot, pS, ptot2) = split_riccati(fin, k, L)
                hold_carry("riccati_prefix:carry", (S,), (pS,), (S_all[:, k:],), worst)
                hold_carry("riccati_total", tot, ptot, (None, S_all[:, k - 1], None),
                           worst)
                # the tail's total through the composition of the two
                whole = el.riccati_combine(tot, tot2)
                err = scaled_err(whole[1], S_all[:, -1])
                assert err < CARRY_RTOL, ("riccati_total composed", J, N, err)
                W = _build.factor_fwd_cuda(*fin)[1]
                for Y in (Y5[..., :1].contiguous(), Y5):
                    for reverse in (False, True):
                        A, b = (assoc.solve_elements(scan.transport_up(t, c), W, U, Y,
                                                     True)
                                if reverse else assoc.solve_elements(p, U, W, Y))
                        F_all = _build.mat_affine_prefix_cuda(A, b, reverse, L)
                        (tot, F), (ptot, pF) = split_mat_affine(A, b, k, reverse, L)
                        hold_carry("mat_affine_prefix:carry", (F,), (pF,),
                                   (F_all[:, :k] if reverse else F_all[:, k:],), worst)
                        hold_carry("mat_affine_total", tot, ptot,
                                   (None, F_all[:, k] if reverse else F_all[:, k - 1]),
                                   worst)
    for D, M in ((9, 1040), (25, 1040), (25, 10_000), (64, 130), (81, 1040)):
        A, b = contracting(D, M, 2, 0.9)
        for reverse in (False, True):
            F_all = _build.mat_affine_prefix_cuda(A, b, reverse)
            k = M // 3 + 1
            (tot, F), (ptot, pF) = split_mat_affine(A, b, k, reverse)
            hold_carry("mat_affine_prefix:carry", (F,), (pF,),
                       (F_all[:, :k] if reverse else F_all[:, k:],), worst)
            hold_carry("mat_affine_total", tot, ptot,
                       (None, F_all[:, k] if reverse else F_all[:, k - 1]), worst)
    for name, (e_whole, e_plain, e_self) in worst.items():
        log("sharded", f"{name}: worst relative error {e_whole:.3e} against the "
            f"zero-start kernels on the whole sequence, {e_plain:.3e} against the "
            f"plain version (whose own distance from the whole reaches "
            f"{e_self:.3e}); N = 130, 1040, 1e4, C = 3 and 1")

    # N = 1e5, one chain, J = 4 and 8 (wide8's stiff term), 1e-9
    for J in (4, 8):
        t, c, a, U, V, Y = wide_system(J, N_MAIN, 1, 1, dev, seed=J)
        p = scan.transport(t, c)
        fin = (p, a, U, V)
        k = N_MAIN // 4
        main = {name: (0.0, 0.0, 0.0) for name in CARRY_KERNELS}
        S_all = _build.riccati_prefix_cuda(*fin)
        (tot, S, _), (ptot, pS, _) = split_riccati(fin, k)
        hold_carry("riccati_prefix:carry", (S,), (pS,), (S_all[:, k:],), main, LONG_RTOL)
        hold_carry("riccati_total", tot, ptot, (None, S_all[:, k - 1], None), main,
                   LONG_RTOL)
        W = _build.factor_fwd_cuda(*fin)[1]
        for reverse in (False, True):
            # the lower solve's elements forward, the upper solve's in reverse
            # (the other order of either grows without bound over 1e5 rows)
            A, b = (assoc.solve_elements(scan.transport_up(t, c), W, U, Y, True)
                    if reverse else assoc.solve_elements(p, U, W, Y))
            F_all = _build.mat_affine_prefix_cuda(A, b, reverse)
            (tot, F), (ptot, pF) = split_mat_affine(A, b, k, reverse)
            hold_carry("mat_affine_prefix:carry", (F,), (pF,),
                       (F_all[:, :k] if reverse else F_all[:, k:],), main, LONG_RTOL)
            hold_carry("mat_affine_total", tot, ptot,
                       (None, F_all[:, k] if reverse else F_all[:, k - 1]), main,
                       LONG_RTOL)
        log("sharded", f"N = 1e5, J = {J}, C = 1, split at {k}: relative errors "
            f"(against the whole, the plain version, the plain's own) {main}")
        del t, c, p, a, U, V, Y, fin, S_all, A, b, W
        torch.cuda.empty_cache()

    wide8_pair_flow(dev)

    # float32 against the float64 kernels
    for J in (2, 4, 8):
        p, a, U, V, Y = prefix_inputs(J, 1040, 3, 1, dev, seed=J)
        fin, k = (p, a, U, V), 347
        (tot, S, _), _ = split_riccati(fin, k, 8)
        A, b = assoc.solve_elements(p, U, _build.factor_fwd_cuda(*fin)[1], Y)
        (mt, F), _ = split_mat_affine(A, b, k, False, 8)
        x32 = [x.float() for x in fin]
        (tot32, S32, _), (ptot32, pS32, _) = split_riccati(x32, k, 8)
        (mt32, F32), (pmt32, pF32) = split_mat_affine(A.float(), b.float(), k, False, 8)
        errs = []
        for g, pl, want in ((S32, pS32, S), (tot32[1], ptot32[1], tot[1]),
                            (F32, pF32, F), (mt32[1], pmt32[1], mt[1])):
            err, tol = scaled_err(g, want), max(1e-4, 2 * scaled_err(pl, want))
            assert torch.isfinite(g).all() and err < tol, (J, err, tol)
            errs.append(f"{err:.2e} (tol {tol:.2e})")
        log("sharded", f"float32, J = {J}, N = 1040, L = 8, split at {k}: "
            "riccati_prefix S from S0, riccati_total Q, mat_affine_prefix F from "
            "x0, mat_affine_total q against the float64 kernels: " + ", ".join(errs))
    return carry_times(dev)


def _walk_host(L, c, x, dtype=np.longdouble):
    """The matrix-affine flow ``x <- L_m x + c_m`` over the rows of one chain
    in descending order, on the host in numpy's ``dtype`` from ``x (D,
    K)``: the value after every row ``(M, D, K)``."""
    L, c = L.cpu().numpy(), c.cpu().numpy()
    x = x.cpu().numpy().astype(dtype)
    out = np.empty(c.shape, dtype)
    for m in range(c.shape[0] - 1, -1, -1):
        x = L[m].astype(dtype) @ x + c[m]
        out[m] = x
    return out


def wide8_pair_flow(dev):
    """``ma_wide`` on the step maps the sharded log-likelihood's adjoint
    really gives it (ROADMAP C9): wide8 (J = 8, D = 81) at N = 1e5 on
    bench.py's data, the paired reverse flow of rows [5e4, 1e5) as two of
    four ranks' shares.  The later share's total map (P, q), q handed on as
    the earlier share's x0, and the earlier share's prefix from it, read
    against a long double walk of the same rows (on the host; P through P v
    + q, the walk from a random v), beside a float64 walk of the same rows
    in the same order on the card (``prefix_engine.mat_affine_walk``) and
    one on the host.  Each of the kernel's errors within ten times the card
    walk's or 1e-10: the gate set from this check's reading (NVIDIA H100
    80GB HBM3, 700.00 W), where the kernel read 1.9 to 6.5 times the card
    walk's 7.5e-9 to 1.8e-8 (ROADMAP C9)."""
    from celerite2_torch.parallel import sharded as sh

    t, y = bench_data(N_MAIN, dev, torch.float64)
    kernel = wide8(torch.tensor(THETA0, device=dev))
    c, a, U, V = (x[None] for x in kernel.get_celerite_matrices(t, torch.full_like(t, 0.0625)))
    _, saved = sh._loglik_forward(t, c, a, U, V, y[None], None)
    B = N_MAIN // 4
    rows = slice(N_MAIN - 2 * B, N_MAIN)
    L, cv, _ = sh.pair_flow(tuple(x[:, rows] if x.dim() > 1 else x for x in saved),
                            torch.ones(1, dtype=t.dtype, device=dev))
    del saved
    mid, late = (tuple(x[:, k * B:(k + 1) * B].contiguous() for x in (L, cv))
                 for k in (0, 1))
    v = torch.tensor(np.random.default_rng(81).normal(size=(1, L.shape[-1], 1)),
                     device=dev)
    P, q = _build.mat_affine_total_cuda(*late, True)
    F = _build.mat_affine_prefix_cuda(*mid, True, x0=q.contiguous())
    walk = pe.mat_affine_walk(L, cv, reverse=True)
    ld = torch.tensor(_walk_host(L[0], cv[0], torch.zeros_like(v[0])).astype(np.float64))
    ld_v = torch.tensor(_walk_host(late[0][0], late[1][0], v[0])[0].astype(np.float64))
    host = torch.tensor(_walk_host(L[0], cv[0], torch.zeros_like(v[0]), np.float64))
    # the float64 walk from v over the later share: x <- L_m x + c_m, rows
    # descending
    x = v
    for m in range(B - 1, -1, -1):
        x = late[0][:, m] @ x + late[1][:, m]
    kern = {"F from x0": scaled_err(F[0], ld[:B]), "q": scaled_err(q[0], ld[B]),
            "P v + q": scaled_err((P @ v + q)[0], ld_v)}
    f64 = {"F from x0": scaled_err(walk[0, :B], ld[:B]), "q": scaled_err(walk[0, B], ld[B]),
           "P v + q": scaled_err(x[0], ld_v)}
    on_host = {"F": scaled_err(host[:B], ld[:B]), "q": scaled_err(host[B], ld[B])}
    log("sharded", f"ma_wide on wide8's paired flow (D = {L.shape[-1]}, rows "
        f"[{rows.start}, {rows.stop}) as two shares of {B}): relative errors against "
        f"a long double walk {kern}, the card's float64 walk's {f64}, the host's "
        f"float64 walk's {on_host}; the largest step map's Frobenius norm "
        f"{torch.linalg.matrix_norm(L[0]).max().item():.3e}")
    for name, err in kern.items():
        assert math.isfinite(err) and err <= max(CARRY_RTOL, 10 * f64[name]), (
            "wide8 pair flow", name, err, f64[name])
    del L, cv, mid, late, walk
    torch.cuda.empty_cache()


def carry_times(dev):
    """The modes' times at the shapes one of four ranks gives them in the
    sharded phase's J = 4 log-likelihood (config5's mixture at N = 1e6:
    B = 250,000 rows a rank, one chain), beside the zero-start calls of the
    same kernels on the same inputs: the Riccati prefix with and without
    the previous row and S0 and its total; the lower solve's matrix-affine
    prefix (D = 4) with and without x0 and its total; and the adjoint's
    reverse one on contracting maps of D = J^2 + 2J + 1 = 25.  Returns
    ``(max_abs, times)`` for the kernels line (each against its plain
    version; times (ms, plain_ms, bound_ms, bound_by))."""
    B, J, D, H = SHARD_ROWS, 4, 25, 64
    p, a, U, V, Y = prefix_inputs(J, H + B, 1, 1, dev, seed=7)
    fin = tuple(x[:, H:].contiguous() for x in (p, a, U, V))
    prev = tuple(x[:, H - 1].contiguous() for x in (a, U, V))
    S0 = _build.riccati_prefix_cuda(*(x[:, :H].contiguous() for x in (p, a, U, V))
                                    )[:, -1].contiguous()
    W = _build.factor_fwd_cuda(p, a, U, V)[1]
    A, b = (x[:, H:].contiguous() for x in assoc.solve_elements(p, U, W, Y))
    x0 = torch.randn_like(b[:, 0])
    rng = np.random.default_rng(3)
    A25 = torch.tensor(rng.normal(size=(1, B, D, D)) * 0.9 / 5.0, device=dev)
    b25 = torch.tensor(rng.normal(size=(1, B, D, 1)), device=dev)
    x25 = torch.randn_like(b25[:, 0])
    runs = {
        "riccati_prefix:carry": (
            lambda: (_build.riccati_prefix_cuda(*fin, prev=prev, S0=S0),),
            lambda: (pe.riccati_prefix_plain(*fin, prev=prev, S0=S0),),
            lambda: _build.riccati_prefix_cuda(*fin), (*fin, *prev, S0), J, None),
        "riccati_total": (
            lambda: _build.riccati_total_cuda(*fin, prev=prev),
            lambda: pe.riccati_total_plain(*fin, prev=prev),
            None, (*fin, *prev), J, None),
        "mat_affine_prefix:carry": (
            lambda: (_build.mat_affine_prefix_cuda(A, b, x0=x0),),
            lambda: (pe.mat_affine_prefix_plain(A, b, x0=x0),),
            lambda: _build.mat_affine_prefix_cuda(A, b), (A, b, x0), J, None),
        "mat_affine_total": (
            lambda: _build.mat_affine_total_cuda(A, b),
            lambda: pe.mat_affine_total_plain(A, b), None, (A, b), J, None),
        "mat_affine_prefix:carry D=25": (
            lambda: (_build.mat_affine_prefix_cuda(A25, b25, True, x0=x25),),
            lambda: (pe.mat_affine_prefix_plain(A25, b25, reverse=True, x0=x25),),
            lambda: _build.mat_affine_prefix_cuda(A25, b25, True), (A25, b25, x25), J,
            D),
        "mat_affine_total D=25": (
            lambda: _build.mat_affine_total_cuda(A25, b25, True),
            lambda: pe.mat_affine_total_plain(A25, b25, reverse=True), None,
            (A25, b25), J, D),
    }
    max_abs, times = {}, {}
    for label, (kernel, plain, zero, inputs, J_, D_) in runs.items():
        name = label.split(" ")[0]
        before = _build.LAUNCHES[name]
        got = kernel()
        torch.cuda.synchronize()
        per_call = _build.LAUNCHES[name] - before
        ms = cuda_ms(kernel, reps=10, warmup=2)
        zero_ms = cuda_ms(zero, reps=10, warmup=2) if zero is not None else None
        want, plain_ms = timed_plain(plain)
        err = max(scaled_err(g, w) for g, w in zip(got, want))
        assert math.isfinite(err) and err < LONG_RTOL, (label, err)
        bound, by = bound_ms((*inputs, *got), carry_flops(name, 1, B, J_, D_))
        log("sharded", f"{label}: {ms:.4f} ms ({per_call} launches; the zero-start "
            f"call {'none' if zero_ms is None else f'{zero_ms:.4f} ms'}; plain "
            f"{plain_ms:.1f} ms, one run; bound {bound:.4f} ms by {by}) at "
            f"B = {B}, one chain, float64; relative error against the plain "
            f"version {err:.2e}")
        if label == name:
            max_abs[name] = max((g - w).abs().max().item() for g, w in zip(got, want))
            times[name] = (ms, plain_ms, bound, by)
        del got, want
    return max_abs, times


# The sharded phase's ranks: four processes on the one card, gloo between
# them (NCCL refuses two ranks on one device); their times are one H100
# time-shared by four ranks, not a speed-up.
SHARD_WORLD = 4
SHARD_N = 1_000_000  # config5's N: B = SHARD_ROWS rows a rank
SHARD_DRAWS = 4  # the pathwise sampler's draws
SHARD_TRAIN = dict(step_size=0.005, num_leapfrog=3)
SHARD_HMC = dict(num_warmup=6, num_samples=4, max_leapfrog=8)
SHARD_C = 64
# gates against the single-rank calls on the card: the log-likelihood's value
# and gradient, the pathwise draws, the train step and run_hmc at 1e-9;
# tests/test_sharding.py's for the ops (:300-313), the mean at new points
# (:556) and the variance (:510)
SHARD_RTOL = 1e-9
OPS_TOLS = {"d": (1e-9, 0.0), "predict_mean_at": (1e-7, 1e-9),
            "variance": (1e-7, 1e-9)}
# wide8's sharded theta-gradient at N = 1e5 against the single-rank card
# route: set from sharded_readings.py (NVIDIA H100 80GB HBM3, 700.00 W; each
# route against a long-double recursion of the value and its tangents): one
# rank 2.15e-8, two 2.24e-8, four 9.47e-8, where the card's scan tier reads
# 1.0e-11 and its assoc tier 4.1e-9 (J = 4: every route within 6.2e-13).
# The digits go to the dense paired reverse flow's stiff step maps and to
# the ranks' total maps composed over 2.5e4 such steps (ROADMAP C9); the
# gate is three times the four-rank reading.
J8_GRAD_RTOL = 3e-7


def _timed_call(fn, dev):
    """``(result, ms)`` of one call, synchronized on both ends."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    sync(dev)
    began = time.perf_counter()
    out = fn()
    sync(dev)
    return out, 1e3 * (time.perf_counter() - began)


def _sharded_loglik_call(mesh, model, theta, t, y, dev):
    """One value and theta-gradient of the sharded log-likelihood after a
    warm-up call: ``(ll, grad, ms, K6 launches, collectives)`` of the call."""
    from celerite2_torch.parallel import comm, make_sharded_logdensity

    logd = make_sharded_logdensity(model, t, y, 0.25, mesh, device=dev)

    def vg():
        th = torch.tensor(theta, device=dev, requires_grad=True)
        ll = logd(th)
        (g,) = torch.autograd.grad(ll, th)
        return ll.detach(), g

    vg()
    torch.distributed.barrier()
    reset_launches()
    comm.COLLECTIVES.update(calls=0, bytes=0)
    (ll, g), ms = _timed_call(vg, dev)
    return (ll.item(), g.cpu().numpy(), ms, dict(_build.LAUNCHES),
            dict(comm.COLLECTIVES))


def sharded_rank(rank, world, init, payload_file, out_dir):
    """One rank of the sharded phase (spawned; the parent built the
    kernels): (a) the log-likelihood's value and gradient, (b) the ops,
    (c) the pathwise sampler on a (1, world) mesh, (d) the train step on a
    (2, world / 2) mesh and run_hmc with its chains over every rank, then
    ``parallel.dryrun.dryrun_multichip``.  Saves what it computed, with its
    times, launches and collectives."""
    import datetime

    import torch.distributed as dist
    from celerite2_torch.parallel import (comm, initialize_distributed, make_mesh,
                                          make_hmc_train_step, seq_sharding)
    from celerite2_torch.parallel import sharded as sh

    torch.set_num_threads(2)
    p = torch.load(payload_file, weights_only=False)
    dev = torch.device(p["device"])
    initialize_distributed("gloo", init_method=init, world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=300))
    out, ms = {}, {}
    mesh = make_mesh(chains=1, seq=world)
    group = mesh.seq_group

    # (a) the log-likelihood: config5's mixture at N = 1e6, wide8 at 1e5
    out["j4"] = _sharded_loglik_call(mesh, sho_mixture, THETA4, *p["j4"], dev)
    out["j8"] = _sharded_loglik_call(mesh, wide8, THETA0, *p["j8"], dev)
    # four ranks and the parent share the card's memory: each returns its
    # cache between the parts
    release = torch.cuda.empty_cache if dev.type == "cuda" else (lambda: None)
    release()

    # (b) the ops at J = 4, N = 1e5, and the predictions
    t, y, t_new, t_var = p["ops"]
    sl = seq_sharding(mesh, t.shape[0])
    kernel = sho_mixture(torch.tensor(THETA4, device=dev))
    tl = torch.tensor(t[sl], device=dev)
    yl = torch.tensor(y[sl], device=dev)[None]
    c, a, U, V = (x[None] for x in kernel.get_celerite_matrices(tl, torch.full_like(tl, 0.0625)))
    (d, W, ok), ms["factor"] = _timed_call(
        lambda: sh.sharded_factor(tl, c, a, U, V, group=group), dev)
    ops = {"d": d, "W": W}
    for name, fn in (
            ("solve_lower", lambda: sh.sharded_solve_lower(tl, c, U, W, yl, group=group)),
            ("solve_upper", lambda: sh.sharded_solve_upper(tl, c, U, W, yl, group=group)),
            ("matmul_lower", lambda: sh.sharded_matmul_lower(tl, c, U, V, yl, group=group)),
            ("matmul_upper", lambda: sh.sharded_matmul_upper(tl, c, U, V, yl, group=group)),
            ("apply_inverse", lambda: sh.sharded_apply_inverse(tl, c, U, W, d, yl,
                                                               group=group)),
            ("dot_tril", lambda: sh.sharded_dot_tril(tl, c, U, W, d, yl, group=group))):
        ops[name], ms[name] = _timed_call(fn, dev)
    tn = torch.tensor(t_new, device=dev)
    _, _, Un, Vn = (x[None] for x in kernel.get_celerite_matrices(tn, torch.zeros_like(tn)))
    ops["predict_mean_at"], ms["predict_mean_at"] = _timed_call(
        lambda: sh.sharded_predict_mean_at(tl, c, a, U, V, yl, tn, Un, Vn, group=group),
        dev)
    tv = torch.tensor(t_var, device=dev)
    KxsT = kernel.get_value(tl[:, None] - tv[None, :])
    k0 = kernel.get_value(torch.zeros(1, dtype=tv.dtype, device=dev))
    ops["variance"], ms["variance"] = _timed_call(
        lambda: sh.sharded_conditional_variance(tl, c, a, U, V, KxsT, k0, group=group), dev)
    out["ops"] = {k: v.cpu().numpy() for k, v in ops.items()}
    out["ok"] = bool(ok.all())
    del ops, KxsT, d, W, c, a, U, V
    release()

    # (c) the pathwise sampler at N = 1e5, M = 1e4 with C8's jitter
    sample = sh.make_sharded_conditional_sampler(
        kernel, t, y, 0.25, t_new, mesh, mean=0.1, regularize=PATHWISE_JITTER["J=4"],
        device=dev)
    draws, ms["pathwise"] = _timed_call(
        lambda: sample(torch.Generator().manual_seed(PATHWISE_SEED), shape=(SHARD_DRAWS,)),
        dev)
    out["pathwise"] = draws.cpu().numpy()
    del sample
    release()

    # (d) the (chains, seq) train step on config3's posterior, two steps
    mesh2 = make_mesh(chains=2, seq=world // 2)
    t3, y3, q0 = p["train"]
    step_fn, _ = make_hmc_train_step(sho_mixture, t3, y3, 0.2, mesh2, device=dev,
                                     **SHARD_TRAIN)
    C = q0.shape[0]
    mine = slice(mesh2.chain_index * C // 2, (mesh2.chain_index + 1) * C // 2)
    gen = torch.Generator().manual_seed(21)
    qs = torch.tensor(q0[mine], device=dev)
    steps = []
    for _ in range(2):
        (qs, acc), step_ms = _timed_call(lambda: step_fn(qs, gen), dev)
        steps.append((qs.cpu().numpy(), acc.cpu().numpy(), step_ms))
    out["train"] = (mine, steps)
    del step_fn
    release()

    # run_hmc with its chains over every rank, each rank's log-density on
    # the card alone
    tt, yy = torch.tensor(t3, device=dev), torch.tensor(y3, device=dev)
    res, ms["run_hmc"] = _timed_call(lambda: run_hmc(
        config3_logpost(tt, yy), torch.tensor(q0, device=dev),
        torch.Generator(dev).manual_seed(11), chain_group=dist.group.WORLD,
        **SHARD_HMC), dev)
    per = C // world
    out["hmc"] = (slice(rank * per, (rank + 1) * per),
                  {k: getattr(res, k).cpu().numpy() for k in res._fields})
    # dryrun_multichip's counterpart on the same ranks: a (1, world) mesh
    from celerite2_torch.parallel.dryrun import dryrun_multichip

    out["dryrun"], ms["dryrun"] = _timed_call(lambda: dryrun_multichip(device=dev), dev)
    out["ms"] = ms
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def sharded_references(dev, payload):
    """The single-rank calls on the card that the ranks are held against:
    ``gp_loglik`` (a), the port's ops and predictions (b),
    ``gp_sample_conditional`` on the same normals (c), the one-rank train
    step and run_hmc on the same draws (d)."""
    from celerite2_torch.parallel import make_hmc_train_step

    refs = {}
    for key, model, theta in (("j4", sho_mixture, THETA4), ("j8", wide8, THETA0)):
        t, y = (torch.tensor(x, device=dev) for x in payload[key])
        ll, g = value_and_grad(torch.tensor(theta, device=dev), t, y, model)
        refs[key] = (ll.item(), g.cpu().numpy())
        del t, y
    t, y, t_new, t_var = (torch.tensor(x, device=dev) for x in payload["ops"])
    kernel = sho_mixture(torch.tensor(THETA4, device=dev))
    c, a, U, V = (x[None] for x in kernel.get_celerite_matrices(t, torch.full_like(t, 0.0625)))
    tc, Y = t[None], y[None, :, None]
    d, W = ct.ops.factor(tc, c, a, U, V)
    lo = ct.ops.solve_lower(tc, c, U, W, Y)
    z0 = torch.sqrt(d)[..., None] * Y
    gp = ct.GaussianProcess(kernel, t, yerr=0.25)
    ops = {"d": d, "W": W, "solve_lower": lo[..., 0],
           "solve_upper": ct.ops.solve_upper(tc, c, U, W, Y)[..., 0],
           "matmul_lower": ct.ops.matmul_lower(tc, c, U, V, Y)[..., 0],
           "matmul_upper": ct.ops.matmul_upper(tc, c, U, V, Y)[..., 0],
           "apply_inverse": ct.ops.solve_upper(tc, c, U, W, lo / d[..., None])[..., 0],
           "dot_tril": (z0 + ct.ops.matmul_lower(tc, c, U, W, z0))[..., 0],
           "predict_mean_at": gp.predict(y, t=t_new, include_mean=False)[None],
           "variance": gp.condition(y, t=t_var).variance[None]}
    refs["ops"] = {k: v.cpu().numpy() for k, v in ops.items()}
    state = ct.gp_compute(kernel, t, yerr=0.25, mean=0.1)
    refs["pathwise"] = ct.gp_sample_conditional(
        state, kernel, y, t_new, torch.Generator().manual_seed(PATHWISE_SEED),
        shape=(SHARD_DRAWS,), mean=0.1, regularize=PATHWISE_JITTER["J=4"]).cpu().numpy()
    t3, y3, q0 = payload["train"]
    step_fn, _ = make_hmc_train_step(sho_mixture, t3, y3, 0.2, None, device=dev,
                                     **SHARD_TRAIN)
    gen, qs, steps = torch.Generator().manual_seed(21), torch.tensor(q0, device=dev), []
    for _ in range(2):
        qs, acc = step_fn(qs, gen)
        steps.append((qs.cpu().numpy(), acc.cpu().numpy()))
    refs["train"] = steps
    tt, yy = torch.tensor(t3, device=dev), torch.tensor(y3, device=dev)
    res = run_hmc(config3_logpost(tt, yy), torch.tensor(q0, device=dev),
                  torch.Generator(dev).manual_seed(11), **SHARD_HMC)
    refs["hmc"] = {k: getattr(res, k).cpu().numpy() for k in res._fields}
    return refs


def _held(label, got, want, rtol, atol=0.0):
    """``got`` against ``want`` within ``rtol`` of the latter's largest entry
    plus ``atol``; returns the relative error."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = np.abs(want).max() + 1e-300
    err = float(np.abs(got - want).max() / scale)
    assert np.isfinite(got).all() and err <= rtol + atol / scale, (label, err, rtol)
    return err


def phase_sharded(dev, smi):
    """The sharded paths (celerite2_torch.parallel) on ranks spawned by this
    process, gloo between them, every rank on the one card: (e) first, the
    K6 modes they run against their plain versions (``phase_carry_kernels``),
    then (a)-(d) on SHARD_WORLD ranks (``sharded_rank``) against the
    single-rank calls on the card (``sharded_references``).  Returns
    ``(max_abs, times, launches)`` of the K6 modes for the kernels line, the
    launches those of one sharded log-likelihood call (value and gradient)
    on the last rank, where S0 and x0 enter the forward passes."""
    began = time.perf_counter()
    max_abs, times = phase_carry_kernels(dev)
    log("time", f"phase_sharded (e), the K6 modes: {time.perf_counter() - began:.1f} s")
    t4, y4 = bench_data(SHARD_N, "cpu", torch.float64)
    t8, y8 = bench_data(N_MAIN, "cpu", torch.float64)
    t3, y3 = config3_data(SAMPLER_N, dev)
    q0 = THETA3 + 0.01 * np.random.default_rng(17).normal(size=(SHARD_C, 5))
    payload = {"j4": (t4.numpy(), y4.numpy()), "j8": (t8.numpy(), y8.numpy()),
               "ops": gp_data(N_MAIN), "train": (t3.cpu().numpy(), y3.cpu().numpy(), q0),
               "device": str(dev)}
    refs = sharded_references(dev, payload)
    _timed_call(lambda: None, dev)
    if dev.type == "cuda":  # the ranks share the card's memory
        torch.cuda.empty_cache()
    spawned = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        payload_file = f"{tmp}/payload.pt"
        torch.save(payload, payload_file)
        torch.multiprocessing.spawn(
            sharded_rank, args=(SHARD_WORLD, f"file://{tmp}/rendezvous", payload_file, tmp),
            nprocs=SHARD_WORLD, join=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(SHARD_WORLD)]
    log("time", f"phase_sharded, {SHARD_WORLD} ranks spawned to joined: "
        f"{time.perf_counter() - spawned:.1f} s")
    shared = f"one {smi.split(',')[0]} time-shared by {SHARD_WORLD} ranks (gloo)"

    # (a) the log-likelihood, replicated on every rank
    k6 = ("riccati_prefix", "riccati_prefix:carry", "riccati_total",
          "mat_affine_prefix", "mat_affine_prefix:carry", "mat_affine_total",
          "affine_prefix")
    for key, label, rows in (("j4", "config5's J = 4 mixture, N = 1e6", SHARD_N),
                             ("j8", "wide8 (J = 8), N = 1e5", N_MAIN)):
        v_ref, g_ref = refs[key]
        for r, res in enumerate(ranks):
            ll, g, ms, launches, coll = res[key]
            ev = _held(f"{key} value", ll, v_ref, SHARD_RTOL)
            eg = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
            tol = SHARD_RTOL if key == "j4" else J8_GRAD_RTOL
            log("sharded", f"(a) {label}, rank {r}: ll {ll:.12g} (single rank "
                f"{v_ref:.12g}), value err {ev:.2e}, grad err {eg:.2e} (tol "
                f"{tol}); {ms:.1f} ms a value and gradient per rank ({shared}); K6 "
                f"launches a call {{{', '.join(f'{k}: {launches[k]}' for k in k6)}}}; "
                f"{coll['calls']} collectives, {coll['bytes']} bytes from this rank")
            assert eg <= tol, (key, r, eg)
    # the last rank's: its forward passes start from S0 and x0 (rank 0's
    # from zero, and its reverse flow from x0)
    launches = ranks[-1]["j4"][3]
    for name in CARRY_KERNELS:
        # (the CPU's plain route, which a rehearsal runs, launches nothing)
        assert launches[name] >= 1 or dev.type == "cpu", (
            f"{name} was not launched on the sharded path")

    # (b) the ops, each rank's rows put back together
    assert all(r["ok"] for r in ranks)
    for name, want in refs["ops"].items():
        rtol, atol = OPS_TOLS.get(name, (1e-8, 1e-10))
        if name in ("predict_mean_at", "variance"):
            errs = [_held(name, r["ops"][name], want, rtol, atol) for r in ranks]
        else:
            errs = [_held(name, np.concatenate([r["ops"][name] for r in ranks], 1),
                          want, rtol, atol)]
        log("sharded", f"(b) {name} at J = 4, N = 1e5: relative error {max(errs):.2e} "
            f"(rtol {rtol:g}, atol {atol:g}); "
            + ", ".join(f"rank {r}: {res['ms'].get(name, res['ms']['factor']):.1f} ms"
                        for r, res in enumerate(ranks)) + f" ({shared})")

    # (c) the pathwise draws on the same normals
    for r, res in enumerate(ranks):
        err = _held("pathwise", res["pathwise"], refs["pathwise"], SHARD_RTOL)
        log("sharded", f"(c) pathwise draws ({SHARD_DRAWS}), N = 1e5, M = 1e4, J = 4, "
            f"regularize {PATHWISE_JITTER['J=4']:g}, rank {r}: relative error "
            f"{err:.2e} against gp_sample_conditional; {res['ms']['pathwise']:.1f} ms "
            f"({shared})")

    # (d) the train step and run_hmc, each rank's chains
    for r, res in enumerate(ranks):
        mine, steps = res["train"]
        for k, ((q, acc, ms), (q_ref, acc_ref)) in enumerate(zip(steps, refs["train"])):
            err = _held("train step", q, q_ref[mine], SHARD_RTOL)
            assert np.array_equal(acc, acc_ref[mine]), ("train accept", r, k)
            log("sharded", f"(d) train step {k + 1} on (2, {SHARD_WORLD // 2}), config3, "
                f"C = {SHARD_C}, rank {r} (chains {mine.start}..{mine.stop - 1}): "
                f"relative error {err:.2e}, accepts equal; {ms:.1f} ms ({shared})")
        mine, hmc = res["hmc"]
        errs = []
        for field, want in refs["hmc"].items():
            if field in ("samples", "log_prob", "accept_prob", "diverging"):
                want = want[mine]
            errs.append(_held(f"run_hmc {field}", hmc[field], want, SHARD_RTOL, 1e-12))
        log("sharded", f"(d) run_hmc over {SHARD_WORLD} ranks, C = {SHARD_C}, rank {r}: "
            f"worst relative error {max(errs):.2e} against the single-rank run; "
            f"{res['ms']['run_hmc']:.0f} ms ({shared})")
    for r, res in enumerate(ranks):
        log("sharded", f"dryrun_multichip's counterpart, rank {r}: {res['dryrun']} "
            f"in {res['ms']['dryrun']:.0f} ms")
    log("time", f"phase_sharded: {time.perf_counter() - began:.1f} s")
    return max_abs, times, launches


# ------------------------------------------------------------ the groups

# run_nuts over a chain group and run_smc over a particle group on
# GROUPS_WORLD gloo ranks spawned as phase_sharded spawns them, every rank on
# the one card; SMC and ADVI on config4's posterior in one process
# (benchmarks/configs.py config4: run_smc with 2048 particles and 10
# mutation steps, :335-341; run_advi with 8 draws a step, of which 300 of
# its 2000 steps run here, :319)
GROUPS_WORLD = 2
GROUPS_RTOL = 1e-9
SMC_P, SMC_MUTATION, SMC_SEED = 2048, 10, 4
# the particles of the stage's mutation held against the CPU route, whose
# value and gradient take 2.6 s at 256 particles and 24 s at 2048 (one
# CPU thread, N = 400)
SMC_HELD = 256
# the particle group against the one-process run: tests/test_sharding.py's
# tolerances (:199-207)
SMC_EVIDENCE_RTOL, SMC_PARTICLES = 1e-8, dict(rtol=1e-6, atol=1e-9)
ADVI_STEPS, ADVI_HELD, ADVI_MC = 300, 20, 8
# a third float64 route (the card's) may lie further from the CPU's plain
# route than the CPU's general route does: its mutated particles read 2.16
# times that distance in a chip run; ten times it, as the sharded phase
# holds ma_wide against a walk in another order (C9)
SPREAD_FACTOR = 10


def config4_smc(t, y):
    """config4's posterior split as run_smc takes it: the log-prior
    N(PRIOR4, I) and its draws, and the log-likelihood (config4_logpost's
    gp_loglik), each batched."""
    mu = torch.tensor(PRIOR4, device=t.device)

    def log_prior(q):
        return -0.5 * ((q - mu) ** 2).sum(-1)

    def log_like(q):
        return ct.gp_loglik(config4_kernel(q), t, y, yerr=0.15)

    def sample_prior(gen, n):
        return mu + torch.randn((n, 5), generator=gen, dtype=torch.float64,
                                device=gen.device)

    return log_prior, log_like, sample_prior


def config4_general_loglik(t, y):
    """config4's log-likelihood through ``ops.factor_solve`` and its adjoint
    (the general route) in place of gp_loglik's fused one: a second float64
    route on the CPU, whose distance from the first says how many digits
    config4's model keeps at given parameters."""
    diag = torch.full_like(t, 0.15**2)

    def log_like(q):
        c, a, U, V = config4_kernel(q).get_celerite_matrices(t, diag)
        C, N = c.shape[0], t.shape[-1]
        d, _, z = ct.ops.factor_solve(t.expand(C, N), c, a, U, V, y.expand(C, N)[..., None])
        return -0.5 * (torch.log(d).sum(-1) + (z[..., 0] ** 2 / d).sum(-1)
                       + N * math.log(2 * math.pi))

    return log_like


def smc_stage(t, y, ll=None, log_like=None):
    """One SMC stage of config4 on t's device, on draws from numpy (seed
    5): SMC_P particles of the prior and their log-likelihoods (by
    ``log_like``, config4_smc's by default); the next temperature from 0 and
    the systematic resampling with a given uniform, both from ``ll`` (numpy)
    where given, else from the log-likelihoods just computed; one mutation
    of SMC_MUTATION leapfrog steps on given momenta and uniforms of the
    first SMC_HELD resampled particles (the whole cloud's spread as the
    scales).  As numpy."""
    dev = t.device
    log_prior, own, _ = config4_smc(t, y)
    log_like = own if log_like is None else log_like
    rng = np.random.default_rng(5)
    q = torch.tensor(PRIOR4 + rng.normal(size=(SMC_P, 5)), device=dev)
    u_res = torch.tensor(rng.uniform(), device=dev)
    z = torch.tensor(rng.normal(size=(SMC_HELD, 5)), device=dev)
    u = torch.tensor(rng.uniform(size=SMC_HELD), device=dev)
    with torch.no_grad():
        values = log_like(q)
    ll = values if ll is None else torch.tensor(ll, device=dev)
    beta = smc._find_next_beta(ll, torch.zeros((), dtype=torch.float64, device=dev))
    q = smc._systematic_resample(u_res, beta * ll, q)
    scales = q.std(dim=0, correction=0) + 1e-12
    q1, acc = smc._hmc_mutation(q[:SMC_HELD], lambda x: log_prior(x) + beta * log_like(x),
                                0.1, scales, z, u, n_steps=SMC_MUTATION)
    return as_numpy({"ll": values, "beta": beta, "resampled": q, "mutated": q1,
                     "accept": acc})


def advi_draws():
    """The ADVI run's standard normals, (ADVI_STEPS, ADVI_MC, 5), seed 6."""
    return np.random.default_rng(6).normal(size=(ADVI_STEPS, ADVI_MC, 5))


def advi_run(t, y, init, steps, log_like=None):
    """run_advi on config4's posterior (its log-likelihood by ``log_like``,
    gp_loglik's by default) from ``init`` for ``steps`` steps of
    :func:`advi_draws`, on t's device: (result as numpy, seconds)."""
    if log_like is None:
        logpost = config4_logpost(t, y)
    else:
        mu = torch.tensor(PRIOR4, device=t.device)

        def logpost(theta):
            return log_like(theta) - 0.5 * ((theta - mu) ** 2).sum(-1)
    draws = torch.tensor(advi_draws()[:steps], device=t.device)
    init = torch.tensor(init, device=t.device)
    res, ms = _timed_call(lambda: run_advi(logpost, init, draws, num_steps=steps,
                                           num_mc_samples=ADVI_MC), t.device)
    return as_numpy(res._asdict()), ms / 1e3


def groups_references(init):
    """What phase_groups holds the card's SMC stage and ADVI run against,
    on the CPU's plain route: :func:`smc_stage`, and run_advi from ``init``
    (the card's MAP of config4) for ADVI_HELD steps; and the same through
    the general route on the same inputs, whose distance from the first is
    the float64 spread of config4's model there."""
    torch.set_num_threads(4)
    t, y = config4_data()
    stage = smc_stage(t, y)
    general = config4_general_loglik(t, y)
    return {"smc_stage": stage,
            "smc_stage general": smc_stage(t, y, ll=stage["ll"], log_like=general),
            "advi": advi_run(t, y, init, ADVI_HELD)[0],
            "advi general": advi_run(t, y, init, ADVI_HELD, log_like=general)[0]}


def launched(launches, where, dev):
    """Every kernel of the sampler's path launched at least once (the CPU's
    plain route, which a rehearsal runs, launches nothing)."""
    for k in SAMPLER_KERNELS:
        assert launches[k] >= 1 or dev.type == "cpu", (where, k, launches)


def in_batches(fn, parts):
    """``fn`` of a batch (B, dim) -> (B,) evaluated on ``parts`` equal
    slices of its input in turn, joined: the batches that the ranks of a
    group of ``parts`` evaluate."""

    def batched(q):
        return torch.cat([fn(x) for x in q.chunk(parts)])

    return batched


def smc_run(t, y, batches=1, **kw):
    """run_smc on config4's posterior at SMC_P particles (generator seeded
    SMC_SEED on t's device), the log-likelihood evaluated in ``batches``
    slices of the cloud, its calls counted and the launches from 0:
    (result as numpy, counted calls, launches, seconds)."""
    log_prior, log_like, sample_prior = config4_smc(t, y)
    counted = CountedCalls(log_like if batches == 1 else in_batches(log_like, batches))
    reset_launches()
    res, ms = _timed_call(lambda: run_smc(
        log_prior, counted, sample_prior, torch.Generator(t.device).manual_seed(SMC_SEED),
        num_particles=SMC_P, mutation_steps=SMC_MUTATION, **kw), t.device)
    return as_numpy(res._asdict()), counted.calls, dict(_build.LAUNCHES), ms / 1e3


def groups_rank(rank, world, init, payload_file, out_dir):
    """One rank of the groups phase (spawned; the parent built the
    kernels): (a) config4's run_nuts with its chains over every rank, each
    transition logged, (b) config4's run_smc with its particles over every
    rank; each with its launches from 0 and its seconds."""
    import datetime

    import torch.distributed as dist
    from celerite2_torch.parallel import initialize_distributed

    torch.set_num_threads(2)
    p = torch.load(payload_file, weights_only=False)
    dev = torch.device(p["device"])
    initialize_distributed("gloo", init_method=init, world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=300))
    group = dist.group.WORLD
    t, y = (torch.tensor(x, device=dev) for x in p["data"])
    out = {}
    reset_launches()
    res, counted, transitions, wall = nuts_run(
        config4_logpost(t, y), p["init"], dev, NUTS_C, NUTS_DEPTH, CONFIG4_RUN,
        chain_group=group)
    out["nuts"] = {"result": as_numpy(res._asdict()), "evals": counted.calls,
                   "wall": wall, "launches": dict(_build.LAUNCHES),
                   "steps": torch.stack(transitions.steps).cpu().numpy(),
                   "q": torch.stack(transitions.q).cpu().numpy()}
    dist.barrier()
    out["smc"] = smc_run(t, y, particle_group=group)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def hold_chain_group(rank, got, want, chains):
    """A rank's config4 run over the chain group against a one-process run's
    chains ``chains``.  Per chain, its departure: the first transition where
    its tree size differs or its draw is more than GROUPS_RTOL from the
    one-process run's (every draw before it is within GROUPS_RTOL by that
    definition).  Without a departure, the whole result is held at
    GROUPS_RTOL too.  Returns (worst error before the departures, {chain:
    (departure, first transition whose tree size differs or None)}, {chain:
    each transition's error})."""
    steps, q = want["steps"][:, chains], want["q"][:, chains]
    T = steps.shape[0]
    worst, departed, curves = 0.0, {}, {}
    for c in range(steps.shape[1]):
        chain = chains.start + c
        errs = np.abs(got["q"][:, c] - q[:, c]).max(-1) / np.abs(q[:, c]).max()
        other = np.flatnonzero(got["steps"][:, c] != steps[:, c])
        off = np.flatnonzero(errs > GROUPS_RTOL)
        d = min(int(off[0]) if off.size else T, int(other[0]) if other.size else T)
        if d:
            worst = max(worst, float(errs[:d].max()))
        curves[chain] = errs
        if d < T:
            departed[chain] = (d, int(other[0]) if other.size else None)
    if not departed:
        for field, value in want["result"].items():
            value = value[chains]
            if field in ("num_steps", "diverging"):
                assert np.array_equal(got["result"][field], value), (rank, field)
            else:
                worst = max(worst, _held(f"run_nuts {field}", got["result"][field],
                                         value, GROUPS_RTOL))
    return worst, departed, curves


def phase_groups(dev, smi, config4_run, refs):
    """The samplers over groups, on config4's posterior (J = 4: K1, K2, K4,
    K5 through gp_loglik): SMC in one process on the card; ADVI on the
    card; GROUPS_WORLD gloo ranks on the card (``groups_rank``) running
    run_nuts over a chain group and run_smc over a particle group, each held
    against the one-process card run that evaluates the same batches (run
    beside the ranks), and set beside phase_nuts's run and the plain SMC
    run; last, one SMC stage's pieces and the first ADVI_HELD ADVI steps
    against the CPU's plain route (``refs``, a worker's, read last so that
    it runs beside the rest)."""
    began = time.perf_counter()
    t, y = (x.to(dev) for x in config4_data())
    one, calls, launches, wall = smc_run(t, y)
    n_stages = int(one["n_stages"])
    assert float(one["final_beta"]) == 1.0 and np.isfinite(one["particles"]).all()
    launched(launches, "run_smc", dev)
    log("groups", f"(b) run_smc, config4, P = {SMC_P}, one process: {n_stages} stages, "
        f"log_evidence {float(one['log_evidence']):.10g}, mutation eps "
        f"{float(one['mutation_eps']):.4g}, posterior mean "
        f"{np.round(one['particles'].mean(0), 4).tolist()}; {wall:.2f} s, "
        f"{1e3 * wall / n_stages:.1f} ms a stage, {calls} log-likelihood calls "
        f"({n_stages} values, {calls - n_stages} values and gradients) of {SMC_P} "
        f"particles, {calls / wall:.2f} calls/s; launches a call "
        + ", ".join(f"{k} {launches[k] / calls:.2f}" for k in SAMPLER_KERNELS)
        + f" ({smi})")

    reset_launches()
    advi, advi_s = advi_run(t, y, config4_run["init"], ADVI_STEPS)
    launches = dict(_build.LAUNCHES)
    launched(launches, "run_advi", dev)
    assert np.isfinite(advi["elbo_trace"]).all()
    log("groups", f"(c) run_advi, config4, {ADVI_MC} draws a step from the MAP, "
        f"{ADVI_STEPS} of 2000 steps: {1e3 * advi_s / ADVI_STEPS:.2f} ms a step; ELBO "
        f"{advi['elbo_trace'][0]:.4f} -> {advi['elbo_trace'][-1]:.4f}, mean "
        f"{np.round(advi['mean'], 4).tolist()}, sd "
        f"{np.round(np.exp(advi['log_sigma']), 4).tolist()}; launches a step "
        + ", ".join(f"{k} {launches[k] / ADVI_STEPS:.2f}" for k in SAMPLER_KERNELS)
        + f" ({smi})")
    held, _ = advi_run(t, y, config4_run["init"], ADVI_HELD)

    # the ranks run beside this process, which runs the same runs evaluating
    # the log-density in the batches the ranks evaluate (GROUPS_WORLD slices
    # of the fleet or the cloud): the card sums a batch of 2 chains in
    # another order than a batch of 4, and config4's float64 gradient keeps
    # about 1e-9 (its fused and general routes on the CPU differ by 2.7e-9),
    # which the trajectories grow; so each group run is held against the
    # one-process run of the same batches, and against phase_nuts's run and
    # the plain one-process SMC run above, whose departures are reported
    payload = {"device": str(dev), "data": as_numpy(config4_data()),
               "init": config4_run["init"]}
    if dev.type == "cuda":  # the ranks share the card's memory
        torch.cuda.empty_cache()
    spawned = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        payload_file = f"{tmp}/payload.pt"
        torch.save(payload, payload_file)
        context = torch.multiprocessing.spawn(
            groups_rank, args=(GROUPS_WORLD, f"file://{tmp}/rendezvous", payload_file, tmp),
            nprocs=GROUPS_WORLD, join=False)
        res, _, transitions, _ = nuts_run(
            in_batches(config4_logpost(t, y), GROUPS_WORLD), config4_run["init"], dev,
            NUTS_C, NUTS_DEPTH, CONFIG4_RUN, on_retry=refuse_retry)
        batched = {"result": as_numpy(res._asdict()),
                   "steps": torch.stack(transitions.steps).cpu().numpy(),
                   "q": torch.stack(transitions.q).cpu().numpy()}
        one_batched = smc_run(t, y, batches=GROUPS_WORLD)[0]
        while not context.join():
            pass
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(GROUPS_WORLD)]
    log("time", f"phase_groups, {GROUPS_WORLD} ranks spawned to joined (the batched "
        f"one-process runs beside them): {time.perf_counter() - spawned:.1f} s")
    shared = f"one {smi.split(',')[0]} time-shared by {GROUPS_WORLD} ranks (gloo)"

    # (a) run_nuts over the chain group
    per = NUTS_C // GROUPS_WORLD
    for r, res in enumerate(ranks):
        got = res["nuts"]
        chains = slice(r * per, (r + 1) * per)
        launched(got["launches"], ("chain group", r), dev)
        worst, departed, _ = hold_chain_group(r, got, batched, chains)
        assert not departed, (r, departed)
        _, parted, curves = hold_chain_group(r, got, config4_run, chains)
        marks = [m for m in (0, 4, 9, 14, 19, 29, 39, 49, 59) if m < len(curves[chains.start])]
        log("groups", f"(a) run_nuts, config4, C = {NUTS_C} over {GROUPS_WORLD} ranks, "
            f"rank {r} (chains {chains.start}..{chains.stop - 1}), max_depth "
            f"{NUTS_DEPTH}, {CONFIG4_RUN}: against the one-process run of the same "
            f"batches, every transition's tree size equal and the whole result within "
            f"tol, worst error {worst:.2e} (tol {GROUPS_RTOL:g}); against phase_nuts's "
            f"run (batches of {NUTS_C}): " + ("; ".join(
                f"chain {c} past tol at transition {d + 1}, tree sizes first differ at "
                f"{'none' if o is None else o + 1}" for c, (d, o) in parted.items())
                or "no chain departs")
            + f"; its draw errors at transitions {[m + 1 for m in marks]}: " + "; ".join(
                f"chain {c} " + ", ".join(f"{curves[c][m]:.1e}" for m in marks)
                for c in curves) + f"; {got['evals']} evals in {got['wall']:.2f} s, "
            f"{got['evals'] / got['wall']:.2f} evals/s a rank (one process, 4 chains: "
            f"{config4_run['evals'] / config4_run['wall']:.2f}); launches a call "
            + ", ".join(f"{k} {got['launches'][k] / got['evals']:.2f}"
                        for k in SAMPLER_KERNELS) + f" ({shared})")

    # (b) run_smc over the particle group
    for r, res in enumerate(ranks):
        got, calls, launches, wall = res["smc"]
        launched(launches, ("particle group", r), dev)
        mine = slice(r * SMC_P // GROUPS_WORLD, (r + 1) * SMC_P // GROUPS_WORLD)
        errs = {}
        for label, want in (("the same batches", one_batched), (f"batches of {SMC_P}", one)):
            stages = int(want["n_stages"]) == int(got["n_stages"])
            ev, eps = (abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                       for k in ("log_evidence", "mutation_eps"))
            ep = float(np.abs(got["particles"] - want["particles"][mine]).max())
            errs[label] = (stages, ev, eps, ep)
        assert int(got["n_stages"]) == int(one_batched["n_stages"]), r
        for field in ("final_beta", "mutation_eps", "log_evidence"):
            np.testing.assert_allclose(got[field], one_batched[field],
                                       rtol=SMC_EVIDENCE_RTOL, err_msg=field)
        np.testing.assert_allclose(got["particles"], one_batched["particles"][mine],
                                   **SMC_PARTICLES)
        log("groups", f"(b) run_smc, config4, P = {SMC_P} over {GROUPS_WORLD} ranks, "
            f"rank {r} ({SMC_P // GROUPS_WORLD} particles), {int(got['n_stages'])} "
            f"stages: against the one-process run of " + "; of ".join(
                f"{label}: stages {'equal' if st else 'differ'}, log_evidence "
                f"{ev:.2e}, mutation_eps {ee:.2e} (relative), particles {ep:.2e} "
                f"(absolute)" for label, (st, ev, ee, ep) in errs.items())
            + f" (gates on the first: evidence rtol {SMC_EVIDENCE_RTOL:g}, particles "
            f"rtol {SMC_PARTICLES['rtol']:g}, atol {SMC_PARTICLES['atol']:g}); "
            f"{wall:.2f} s, {1e3 * wall / n_stages:.1f} ms a stage, "
            f"{calls / wall:.2f} log-likelihood calls/s a rank; launches a call "
            + ", ".join(f"{k} {launches[k] / calls:.2f}" for k in SAMPLER_KERNELS)
            + f" ({shared})")

    # the card against the CPU route on the same draws, each within 1e-9 or
    # SPREAD_FACTOR times the distance of the CPU's two float64 routes on
    # the same inputs, where config4's model keeps fewer digits (far prior
    # draws: the routes' log-likelihoods 7.9e-8 apart, relative to the
    # largest, on the CPU)
    waited = time.perf_counter()
    want = refs.get()
    waited = time.perf_counter() - waited
    stage = smc_stage(t, y, ll=want["smc_stage"]["ll"])

    def held_within_spread(label, got, cpu, general):
        spread = float(np.abs(general - cpu).max() / np.abs(cpu).max())
        tol = max(GROUPS_RTOL, SPREAD_FACTOR * spread)
        return _held(label, got, cpu, tol), spread, tol

    errs = {k: held_within_spread(f"smc stage {k}", stage[k], want["smc_stage"][k],
                                  want["smc_stage general"][k])
            for k in ("ll", "mutated")}
    errs.update({k: (_held(f"smc stage {k}", stage[k], want["smc_stage"][k], GROUPS_RTOL),
                     None, GROUPS_RTOL) for k in ("beta", "resampled")})
    assert np.array_equal(stage["accept"], want["smc_stage"]["accept"])
    log("groups", f"(b) one SMC stage of config4 on numpy draws, P = {SMC_P} (the "
        f"mutation's {SMC_MUTATION} leapfrog steps on {SMC_HELD} of them; the "
        f"temperature, resampling and mutation from the CPU's log-likelihoods): card "
        f"against the CPU route " + ", ".join(
            f"{k} {e:.2e} (" + ("" if sp is None else f"the CPU routes' spread {sp:.2e}, ")
            + f"tol {tol:.2e})" for k, (e, sp, tol) in errs.items())
        + f"; accepts equal ({int(stage['accept'].sum())} of {SMC_HELD}); beta "
        f"{float(stage['beta']):.6g} ({smi})")
    errs = {k: held_within_spread(f"advi {k}", held[k], want["advi"][k],
                                  want["advi general"][k])
            for k in ("mean", "log_sigma", "elbo_trace")}
    errs["elbo_trace of the long run"] = held_within_spread(
        "advi elbo_trace", advi["elbo_trace"][:ADVI_HELD], want["advi"]["elbo_trace"],
        want["advi general"]["elbo_trace"])
    log("groups", f"(c) run_advi, card against the CPU route on the same draws, first "
        f"{ADVI_HELD} steps: " + ", ".join(
            f"{k} {e:.2e} (spread {sp:.2e}, tol {tol:.2e})"
            for k, (e, sp, tol) in errs.items())
        + f"; the CPU worker waited for {waited:.1f} s ({smi})")
    log("time", f"phase_groups: {time.perf_counter() - began:.1f} s")


def phase_cpu_driver(dev, smi):
    """The native CPU driver (``celerite2_torch.cpu``), built with g++ on
    the card machine's host: ``NumpyGaussianProcess`` on bench.py's data at
    N = 1e5 for config5's J = 4 mixture and wide8 (J = 8), its
    log-likelihood and predictive mean at M = 1e4 held against the card's
    GaussianProcess at 1e-9 relative in float64, and its ms a call on the
    host beside the card's."""
    from celerite2_torch.cpu import NumpyGaussianProcess, bindings

    began = time.perf_counter()
    lib = bindings.build()
    log("cpu_driver", f"g++ {' '.join(bindings.GXX_FLAGS)}: {lib.name} in "
        f"{time.perf_counter() - began:.2f} s")
    cpu = "not read"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    host = f"host CPU {cpu}, one thread; card {smi}"
    t, y, t_new, _ = gp_data(N_MAIN)
    for label, model, theta in (("config5's J = 4 mixture", sho_mixture, THETA4),
                                ("wide8 (J = 8)", wide8, THETA0)):
        card_ms, host_ms = {}, {}
        gp, card_ms["compute"] = _timed_call(
            lambda: ct.GaussianProcess(model(torch.tensor(theta, device=dev)), t,
                                       yerr=0.25, mean=0.1), dev)
        ll, card_ms["log_likelihood"] = _timed_call(lambda: gp.log_likelihood(y), dev)
        mu, card_ms["predict M=1e4"] = _timed_call(lambda: gp.predict(y, t=t_new), dev)
        kernel = model(torch.tensor(theta))
        began = time.perf_counter()
        npgp = NumpyGaussianProcess(kernel, t, yerr=0.25, mean=0.1)
        host_ms["compute"] = 1e3 * (time.perf_counter() - began)
        began = time.perf_counter()
        ll_host = npgp.log_likelihood(y)
        host_ms["log_likelihood"] = 1e3 * (time.perf_counter() - began)
        began = time.perf_counter()
        mu_host = npgp.predict(y, t=t_new)
        host_ms["predict M=1e4"] = 1e3 * (time.perf_counter() - began)
        e_ll = _held("cpu driver log_likelihood", ll_host, ll.item(), GROUPS_RTOL)
        e_mu = _held("cpu driver predict", mu_host, mu.cpu().numpy(), GROUPS_RTOL)
        log("cpu_driver", f"{label}, N = {N_MAIN}: NumpyGaussianProcess against the card's "
            f"GaussianProcess, log_likelihood {e_ll:.2e}, predictive mean at M = 1e4 "
            f"{e_mu:.2e} (tol {GROUPS_RTOL:g}); ms a call on the host "
            + ", ".join(f"{k} {v:.1f}" for k, v in host_ms.items())
            + "; on the card " + ", ".join(f"{k} {v:.1f}" for k, v in card_ms.items())
            + f" ({host})")


# The layout probe's kernels (csrc/slab_layout.cu): the TPU kernel each
# replaces.  Held exactly against their plain versions at the probe's
# planes for these N and at general planes (E, TOT, LP, s): whole 32 x 32
# tiles, and tiles cut at both edges.
LAYOUT_TPU = {"slab_transpose": "benchmarks/probe_transpose_tpu.py:119",
              "slab_inverse": "benchmarks/probe_transpose_tpu.py:144"}
LAYOUT_N = (1, 8, 5000, 8192, 8193, 100_000, 1_000_000)
LAYOUT_GENERAL = ((3, 160, 96, 5), (3, 150, 70, 3))
LAYOUT_TIMED = (100_000, 1_000_000)
# evaluations a call of the probe's path (its default)
LAYOUT_CHAIN = 400
# the probe's arms that sum all twelve planes, in float32 in another order
# each: they agree within float32 rounding of 60 000 terms of the sum
LAYOUT_VAL_RTOL = 2e-4


def queued_ms(fn, reps, sleep_cycles=20_000_000):
    """Device milliseconds a call of ``fn`` takes when calls run back to
    back: ``reps`` calls queued behind a sleeping kernel, CUDA events around
    them, so that the host's launch time stays out of a kernel of a few
    microseconds.  The sleep is lengthened until the host has queued every
    call before the card reaches the first event."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        sleep_cycles *= 4
    raise RuntimeError("queued_ms: the host could not queue the calls ahead of the card")


def phase_layout(dev, smi):
    """The layout probe's kernels K15 (``slab_transpose``) and K16
    (``slab_inverse``), float32: (a) each against its plain version on the
    card, exactly (a transpose moves bits), and the round trip against its
    input, at the probe's planes for :data:`LAYOUT_N` and at
    :data:`LAYOUT_GENERAL`; (b) at N = 1e5 and 1e6, each kernel's device
    ms beside its bound (bytes), its plain version, the PyTorch call that
    computes the same (``transpose(1, 2).contiguous()``) and a device copy
    of the same bytes, each timed by :func:`queued_ms` with its inputs
    rotated past the L2 (cold reads); (c) the probe's path,
    ``probes.transpose.main(1e5, 400)``, whose K15 and K16 layouts must equal
    PyTorch's transpose and its input bit for bit.  Returns each kernel's
    largest error, its times at N = 1e5 and its launches on the path."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = dict.fromkeys(LAYOUT_TPU, 0.0)
    shapes = [(layout_probe.E, g.TOT, g.LP, g.s)
              for g in map(layout_probe.SlabGeometry, LAYOUT_N)]
    for E, TOT, LP, s in shapes + list(LAYOUT_GENERAL):
        x = torch.randn(E, TOT, LP, device=dev, generator=gen)
        y = _build.slab_transpose_cuda(x, s)
        z = _build.slab_inverse_cuda(y)
        checks = (("slab_transpose", y, layout.slab_transpose_plain(x, s)),
                  ("slab_inverse", z, layout.slab_inverse_plain(y)),
                  ("round trip", z, x))
        for name, got, want in checks:
            assert got.shape == want.shape, (name, tuple(got.shape), tuple(want.shape))
            err = (got - want).abs().max().item()
            assert torch.equal(got, want), (name, (E, TOT, LP, s), err)
            if name in worst:
                worst[name] = max(worst[name], err)
    log("layout", f"K15 and K16 equal to their plain versions bit for bit, and "
        f"the round trip to its input, at (E, TOT, LP, s) = "
        + ", ".join(map(str, shapes + list(LAYOUT_GENERAL))))

    times = {}
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for N in LAYOUT_TIMED:
        g = layout_probe.SlabGeometry(N)
        E = layout_probe.E
        nbytes = 2 * E * g.TOT * g.LP * 4
        bound, by = bytes_or_ops(nbytes, 0, torch.float32)
        # inputs (x, y = K15(x), a copy's target) in as many sets as keep
        # each call's reads out of the L2: between two calls on one set the
        # calls on the others move twice the L2's bytes
        sets = []
        for _ in range(-(-2 * l2 // nbytes) + 1):
            x = torch.randn(E, g.TOT, g.LP, device=dev, generator=gen)
            sets.append((x, _build.slab_transpose_cuda(x, g.s), torch.empty_like(x)))

        def cold(fn, reps):
            turn = itertools.cycle(sets)
            return queued_ms(lambda: fn(*next(turn)), reps)

        copy = cold(lambda x, y, into: into.copy_(x), 100)
        calls = {
            "slab_transpose": (lambda x, y, into: _build.slab_transpose_cuda(x, g.s),
                               lambda x, y, into: layout.slab_transpose_plain(x, g.s),
                               lambda x, y, into: x.transpose(1, 2).contiguous()),
            "slab_inverse": (lambda x, y, into: _build.slab_inverse_cuda(y),
                             lambda x, y, into: layout.slab_inverse_plain(y),
                             lambda x, y, into: y.view(E, g.LP, g.TOT).transpose(1, 2)
                             .contiguous()),
        }
        for name, (kernel, plain, library) in calls.items():
            t = {"ms": cold(kernel, 100), "plain_ms": cold(plain, 10),
                 "library_ms": cold(library, 100), "copy_ms": copy,
                 "bound_ms": bound, "bound_by": by}
            times[name, N] = t
            log("layout", f"{name} at N = {N} ({E}, {g.TOT}, {g.LP}) float32: "
                f"{t['ms']:.4f} ms, bound {bound:.4f} ({by}), transpose(1, 2)."
                f"contiguous() {t['library_ms']:.4f}, copy_ {copy:.4f}, plain "
                f"{t['plain_ms']:.4f} (device ms a call, queued back to back, "
                f"inputs rotated over {len(sets)} sets past the {l2 / 2**20:.0f} "
                f"MiB L2; {smi})")
        del sets

    reset_launches()
    began = time.perf_counter()
    run = layout_probe.main(N_MAIN, LAYOUT_CHAIN, device=dev)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES[name] for name in LAYOUT_TPU}
    seconds = time.perf_counter() - began
    lay, arms = run["layouts"], run["arms"]
    assert torch.equal(lay["cuda-T"], lay["torch-T2d (batched 2d)"]), "cuda-T layout"
    assert torch.equal(lay["cuda round trip"], lay["natural"]), "cuda round trip layout"
    assert arms["cuda-T"]["launches"] == {"slab_transpose": 1.0, "slab_inverse": 0.0}, arms
    assert arms["cuda round trip"]["launches"] == {"slab_transpose": 1.0,
                                                   "slab_inverse": 1.0}, arms
    want = arms["stack only"]["val"]
    for label, reading in arms.items():
        assert math.isfinite(reading["val"]), (label, reading)
        if label != "noop (2-plane sum)":
            rel = abs(reading["val"] - want) / abs(want)
            assert rel < LAYOUT_VAL_RTOL, (label, reading["val"], want)
    log("layout", f"probes.transpose.main({N_MAIN}, {LAYOUT_CHAIN}) in {seconds:.1f} s "
        f"(layouts of cuda-T and the round trip bit for bit; values within "
        f"{LAYOUT_VAL_RTOL:g} of the stack's; ms an eval from a CUDA graph's "
        f"replay): " + "; ".join(
            f"{label} {r['ms']:.4f} ms/eval (K15 {r['launches']['slab_transpose']:g}, "
            f"K16 {r['launches']['slab_inverse']:g} an eval)" for label, r in arms.items())
        + f"; launches on the path {launches} ({smi})")
    return worst, {name: times[name, N_MAIN] for name in LAYOUT_TPU}, launches


def phase_pathwise(dev, smi, refs, fleet_theta):
    """Posterior-predictive draws under backend="auto", float64: (a) the
    quick start at N = 1e5, M = 1e4 (J = 4 and 8) against the CPU route,
    (b) the exact law of a component conditional, (c) the fleet of 64
    posterior states, (d) the adapters."""
    with tier("auto"):
        gp4 = pathwise_quick_start(dev, smi, refs)
        small = pathwise_exact_law(dev, smi)
        pathwise_fleet(dev, smi, fleet_theta)
        pathwise_adapters(dev, smi, gp4, small)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also time the fused kernels, evals/s and the "
                        "assoc tier's prefixes for several block lengths")
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
    # the plain references on the CPU, each in a worker started now, or for
    # the last phases once the general kernels' workers are done
    refs = CpuReferences(cpu_references, N_MAIN)
    grid_refs = [CpuReferences(grid_references, Js) for Js in GRID_WORKERS]
    main_refs = CpuReferences(main_shape_references)
    workers = [refs, *grid_refs, main_refs]
    try:
        timed(phase_build)
        main_abs, times = timed(phase_kernels, dev)
        timed(phase_frev, dev)
        # the phases that need no CPU reference first, the general kernels'
        # workers running meanwhile: the assoc tier's kernels, then the
        # card's paths that check themselves
        for phase, phase_args in ((phase_assoc_kernels, (dev,)),
                                  (phase_prefix_kernel, (dev,))):
            phase_abs, phase_times = timed(phase, *phase_args)
            main_abs.update(phase_abs)
            times.update(phase_times)
        timed(phase_chains, dev)
        timed(phase_quiet_failure, dev)
        timed(phase_steps, dev)
        timed(phase_profile, dev, "J = 2", sho, THETA0, 2)
        timed(phase_profile, dev, "J = 4", sho_mixture, THETA4, 4)
        timed(phase_profile, dev, "J = 8", wide8, THETA0, 8)
        hmc_rate, fleet_theta = timed(phase_sampler, dev, smi)
        carry_abs, carry_times, launches_sharded = timed(phase_sharded, dev, smi)
        phase_abs, phase_times = timed(phase_general_kernels, dev, grid_refs, main_refs)
        main_abs.update(phase_abs)
        times.update(phase_times)
        # the general kernels' references are in: the later phases' workers
        # start beside the adjoint kernels' phase
        nuts_refs = CpuReferences(nuts_references)
        terms_refs = CpuReferences(terms_references, TERMS_N)
        pathwise_refs = CpuReferences(pathwise_references)
        workers += [nuts_refs, terms_refs, pathwise_refs]
        phase_abs, phase_times = timed(phase_adjoint_kernels, dev, grid_refs, main_refs)
        main_abs.update(phase_abs)
        times.update(phase_times)
        for w in (*grid_refs, main_refs):
            w.stop()
        launches = timed(phase_main_path, dev)
        launches4 = timed(phase_main_path_j4, dev)
        launches8 = timed(phase_gp_path, dev, smi, refs)
        launches_train = timed(phase_train_j8, dev, smi, refs)
        launches_assoc, ok32 = timed(phase_assoc_path, dev, smi, refs)
        refs.stop()
        timed(phase_auto_path, dev, smi)
        timed(phase_crossover, dev, ok32)
        config4_run = timed(phase_nuts, dev, smi, nuts_refs, hmc_rate)
        # the CPU route of the groups phase's SMC stage and ADVI runs, from
        # the MAP that phase_nuts found
        groups_refs = CpuReferences(groups_references, config4_run["init"])
        workers.append(groups_refs)
        timed(phase_terms, dev, smi, terms_refs)
        timed(phase_pathwise, dev, smi, pathwise_refs, fleet_theta)
        timed(phase_groups, dev, smi, config4_run, groups_refs)
        timed(phase_cpu_driver, dev, smi)
        layout_abs, layout_times, launches_layout = timed(phase_layout, dev, smi)
    finally:
        for w in workers:
            w.stop()
    if args.sweep:
        timed(phase_sweep, dev)
        timed(phase_prefix_sweep, dev)
        timed(phase_affine_sweep, dev)
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
    # where each plain_ms was taken: the tile ring's plain versions run once,
    # in a CPU worker; the others on the card
    plain_on_cpu = ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": TPU_KERNEL[name], "launches": on_path[name][name],
         "max_abs_err": main_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1],
         "plain_device": "cpu" if name in plain_on_cpu else "cuda",
         "bound_ms": times[name][2],
         "bound_by": times[name][3], "library_ms": None}
        for name in on_path
    ]
    # the K6 modes of the sharded paths: launches of one sharded
    # log-likelihood value and gradient on the last rank of four
    kernels += [
        {"name": name, "route": "cuda", "source": SOURCE[key], "replaces": tpu,
         "launches": launches_sharded[name], "max_abs_err": carry_abs[name],
         "ms": carry_times[name][0], "plain_ms": carry_times[name][1],
         "plain_device": "cuda", "bound_ms": carry_times[name][2],
         "bound_by": carry_times[name][3], "library_ms": None}
        for name, (key, tpu) in CARRY_KERNELS.items()
    ]
    # the layout probe's kernels: launches on its path, main(1e5, 400)
    kernels += [
        {"name": name, "route": "cuda", "source": "celerite2_torch/csrc/slab_layout.cu",
         "replaces": tpu, "launches": launches_layout[name],
         "max_abs_err": layout_abs[name], "ms": layout_times[name]["ms"],
         "plain_ms": layout_times[name]["plain_ms"], "plain_device": "cuda",
         "bound_ms": layout_times[name]["bound_ms"],
         "bound_by": layout_times[name]["bound_by"],
         "library_ms": layout_times[name]["library_ms"],
         "copy_ms": layout_times[name]["copy_ms"]}
        for name, tpu in LAYOUT_TPU.items()
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
