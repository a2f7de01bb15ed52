"""Build, bind and launch the hand-written CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (Hopper) at first
use into ``celerite2_torch/_build/`` (ignored by git), as a shared
library with a plain C interface, and bound with ``ctypes``.  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt, and a process that builds at the same time as another
never loads a half-written file.

Each wrapper checks its tensors (CUDA, one device, float32 or float64
(the layout kernels float32 only), contiguous, the expected shapes),
allocates the outputs with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch failed, and counts the
launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from celerite2_torch.config import J_BUCKETS

__all__ = [
    "LAUNCHES",
    "build",
    "fused_block_len",
    "factor_adjoint_block_len",
    "structured_block_len",
    "kalman_fwd_cuda",
    "solve_rev_cuda",
    "factor_rev_cuda",
    "frev_maps_cuda",
    "frev_states_cuda",
    "factor_fwd_cuda",
    "sweep_fwd_cuda",
    "factor_bwd_cuda",
    "sweep_bwd_cuda",
    "ring",
    "affine_run_len",
    "affine_prefix_cuda",
    "riccati_prefix_cuda",
    "riccati_total_cuda",
    "kalman_prefix_cuda",
    "mat_affine_block_len",
    "mat_affine_prefix_cuda",
    "mat_affine_total_cuda",
    "slab_transpose_cuda",
    "slab_inverse_cuda",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
)

# Launches of each kernel since the last reset (a plain count per
# kernel, so a run can show that its main path went through them).  The
# prefixes' launches from an incoming state (``S0``, ``x0``) count under
# ``<kernel>:carry``, apart from their zero-start launches.
LAUNCHES = {
    "kalman_fwd": 0,
    "solve_rev": 0,
    "factor_rev": 0,
    "frev_maps": 0,
    "frev_states": 0,
    "factor_fwd": 0,
    "sweep_fwd": 0,
    "factor_bwd": 0,
    "sweep_bwd": 0,
    "affine_prefix": 0,
    "riccati_prefix": 0,
    "riccati_prefix:carry": 0,
    "riccati_total": 0,
    "kalman_prefix": 0,
    "mat_affine_prefix": 0,
    "mat_affine_prefix:carry": 0,
    "mat_affine_total": 0,
    "slab_transpose": 0,
    "slab_inverse": 0,
}

# The celerite widths J each kernel is built for (csrc/fused_loglik.cu;
# csrc/general_ops.cu and csrc/assoc_prefix.cu at the buckets of
# config.J_BUCKETS).  The affine prefixes take their width at run time and
# are not listed.
WIDTHS = {
    "kalman_fwd": (1, 2, 3, 4),
    "solve_rev": (1, 2, 3, 4),
    "factor_rev": (1, 2),
    "frev_maps": (1, 2, 3, 4),
    "frev_states": (1, 2, 3, 4),
    "factor_fwd": J_BUCKETS,
    "sweep_fwd": J_BUCKETS,
    "factor_bwd": J_BUCKETS,
    "sweep_bwd": J_BUCKETS,
    "riccati_prefix": J_BUCKETS,
    "riccati_total": J_BUCKETS,
    "kalman_prefix": J_BUCKETS,
}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path.  Each source is compiled by its own ``nvcc``
    process, all started together, and the objects are linked into one
    shared library.  ``<library>.log`` keeps nvcc's output (ptxas
    register and spill counts) and the build time."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libcelerite2_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    start = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [
            f"{src.name} ({proc.returncode}):\n{out}"
            for src, proc, out in zip(sources, procs, outputs)
            if proc.returncode != 0
        ]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}\n"
                f"{link.stderr}"
            )
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    lib.with_suffix(".log").write_text(
        f"build_seconds {seconds:.3f}\n" + "".join(outputs)
    )
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        # (is_double, J, inputs..., outputs..., scratch..., C, N, L, stream)
        for name, n_arrays in (
            ("c2t_kalman_fwd", 10),
            ("c2t_solve_rev", 8),
            ("c2t_factor_rev", 9),
            ("c2t_frev_maps", 7),
            ("c2t_frev_states", 9),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [I, I] + [P] * n_arrays + [I, I, I, P]
            fn.restype = I
        # (is_double, J, inputs..., outputs..., C, N, stream)
        lib.c2t_factor_fwd.argtypes = [I, I] + [P] * 7 + [I, I, P]
        lib.c2t_factor_fwd.restype = I
        # (is_double, J, inputs..., outputs..., C, N, K, is_solve, upper, stream)
        lib.c2t_sweep_fwd.argtypes = [I, I] + [P] * 6 + [I] * 5 + [P]
        lib.c2t_sweep_fwd.restype = I
        lib.c2t_factor_bwd.argtypes = [I, I] + [P] * 11 + [I, I, P]
        lib.c2t_factor_bwd.restype = I
        lib.c2t_sweep_bwd.argtypes = [I, I] + [P] * 10 + [I] * 5 + [P]
        lib.c2t_sweep_bwd.restype = I
        # (is_double, J, kernel, K, C, with_out, chains, bytes)
        lib.c2t_ring.argtypes = [I] * 6 + [P] * 2
        lib.c2t_ring.restype = I
        # (is_double, phi, G, F, status, values, C, M, J, K, run, reverse,
        #  stream)
        lib.c2t_affine_prefix.argtypes = [I] + [P] * 5 + [I] * 6 + [P]
        lib.c2t_affine_prefix.restype = I
        # (C, M, J, K, run) -> status words, the ticket included
        lib.c2t_affine_status.argtypes = [I] * 5
        lib.c2t_affine_status.restype = ctypes.c_longlong
        # (is_double, J, p, a, U, V, Y, a_prev, U_prev, V_prev, S0, S, F,
        #  work, C, N, K, L, launched, stream)
        lib.c2t_riccati_prefix.argtypes = ([I, I] + [P] * 12 + [I] * 4
                                           + [ctypes.POINTER(I), P])
        lib.c2t_riccati_prefix.restype = I
        # (is_double, J, p, a, U, V, a_prev, U_prev, V_prev, total, work, C,
        #  N, L, launched, stream)
        lib.c2t_riccati_total.argtypes = ([I, I] + [P] * 9 + [I] * 3
                                          + [ctypes.POINTER(I), P])
        lib.c2t_riccati_total.restype = I
        # (J, C, N, L) -> values of scratch
        lib.c2t_riccati_total_work.argtypes = [I] * 4
        lib.c2t_riccati_total_work.restype = ctypes.c_longlong
        lib.c2t_riccati_group.argtypes = []
        lib.c2t_riccati_group.restype = I
        # (J, C, N, K, L) -> values of scratch
        lib.c2t_riccati_work.argtypes = [I] * 5
        lib.c2t_riccati_work.restype = ctypes.c_longlong
        # (is_double, A, b, x0, F, work, C, M, D, K, L, reverse, launched,
        #  stream)
        lib.c2t_mat_affine_prefix.argtypes = ([I] + [P] * 5 + [I] * 6
                                              + [ctypes.POINTER(I), P])
        lib.c2t_mat_affine_prefix.restype = I
        # (is_double, A, b, P, q, work, C, M, D, K, L, reverse, launched,
        #  stream)
        lib.c2t_mat_affine_total.argtypes = ([I] + [P] * 5 + [I] * 6
                                             + [ctypes.POINTER(I), P])
        lib.c2t_mat_affine_total.restype = I
        # (D, C, M, K, L, total) -> values of scratch
        lib.c2t_mat_affine_work.argtypes = [I] * 6
        lib.c2t_mat_affine_work.restype = ctypes.c_longlong
        lib.c2t_mat_affine_group.argtypes = [I]
        lib.c2t_mat_affine_group.restype = I
        # (x, y, E, rows, columns, stream): csrc/slab_layout.cu
        for name in ("c2t_slab_transpose", "c2t_slab_inverse"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, I, I, I, P]
            fn.restype = I
        _lib = lib
    return _lib


def _check(name, tensors, shapes):
    first = tensors[0]
    for t, shape in zip(tensors, shapes):
        if not t.is_cuda:
            raise ValueError(f"{name}: expects CUDA tensors, got {t.device}")
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: tensors must share device and dtype")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: float32 or float64 only, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _row_shapes(C, N, J, n_vec, n_scalar):
    return ((C, N, J),) * n_vec + ((C, N),) * n_scalar


def fused_block_len(N):
    """Rows per block of K1 and K2 on the card: the power of two at or
    above sqrt(N) / 10, at least 32.  A walk's time grows with L, the scan
    over the blocks' maps with N / L; the rule follows the sweep of
    ``chip_smoke.py --sweep`` (PERF.md), where at 64 chains the block
    length moved the eval by under 5% from 32 to 512 rows."""
    L = 32
    while 100 * L * L < N:
        L *= 2
    return L


# Rows per block of the dense factor adjoint K3 on the card: the rule of K1
# and K2, which ``chip_smoke.py --sweep`` holds against the other block
# lengths (PERF.md), under a name of its own that the sweep can set apart.
factor_adjoint_block_len = fused_block_len


# blocks of the fused kernels' rows in a group: the walks of one of their
# thread blocks (csrc/fused_loglik.cu, kWalks)
FUSED_GROUP = 32
# the H100's multiprocessors, on each of which K4 walks one group at a time
CARD_SMS = 132


def structured_block_len(N, C=1):
    """Rows per block of K4 and K5 on the card (K5 starts each block from
    K4's suffixes of the blocks after it): K1's rule, doubled up to 256
    rows while the C chains' groups of :data:`FUSED_GROUP` blocks fill
    more than one wave of K4's thread blocks, one a multiprocessor.  Past
    one wave a doubling halves K4's waves, and shorter blocks cost K5's
    scan more groups (``chip_smoke.py --sweep``, PERF.md)."""
    L = fused_block_len(N)
    while L < 256 and C * -(-N // L) > CARD_SMS * FUSED_GROUP:
        L *= 2
    return L


def _block_len(key, block_len, N, rule):
    L = rule(N) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    return L


def _two_level(key, J, inputs, outs, C, N, L, map_width, state_width):
    """Launch K1, K2 or K3 (``c2t_<key>``, one call) in blocks of L
    rows: with more than one block, the block maps; with more than one
    group of blocks, the scan over the groups; the rows.  Each kernel
    counts in :data:`LAUNCHES`."""
    if min(C, N) < 1:
        raise ValueError(f"{key}: empty system (C={C}, N={N})")
    NB = -(-N // L)
    GB = -(-NB // FUSED_GROUP)
    x = inputs[0]
    scratch = (
        _empty(x, C, NB, map_width) if NB > 1 else None,
        _empty(x, C, GB, map_width) if NB > 1 else None,
        _empty(x, C, GB, state_width) if GB > 1 else None,
    )
    _launch_general(key, J, inputs, (*outs, *scratch), (C, N, L))
    LAUNCHES[key] += (NB > 1) + (GB > 1)


def kalman_fwd_cuda(p, U, V, ainv, y, block_len=None):
    """K1 on the card: the Kalman pass's per-row states, ``S (C, N, J, J)``
    and ``F (C, N, J)``, in blocks of ``block_len`` rows (default
    :func:`fused_block_len`)."""
    C, N, J = U.shape
    inputs = (p, U, V, ainv, y)
    _check("kalman_fwd", inputs, _row_shapes(C, N, J, 3, 2))
    outs = (_empty(p, C, N, J, J), _empty(p, C, N, J))
    L = _block_len("kalman_fwd", block_len, N, fused_block_len)
    _two_level("kalman_fwd", J, inputs, outs, C, N, L, 3 * J * J + 2 * J,
               J * J + J)
    return outs


def solve_rev_cuda(p, U, W, bz, block_len=None):
    """K2 on the card: the solve adjoint's per-row suffix states
    ``Rst (C, N, J)``, in blocks of ``block_len`` rows (default
    :func:`fused_block_len`)."""
    C, N, J = U.shape
    inputs = (p, U, W, bz)
    _check("solve_rev", inputs, _row_shapes(C, N, J, 3, 1))
    out = _empty(p, C, N, J)
    L = _block_len("solve_rev", block_len, N, fused_block_len)
    _two_level("solve_rev", J, inputs, (out,), C, N, L, J * J + J, J)
    return out


def factor_rev_cuda(p, U, W, bv0, bdp, block_len=None):
    """K3 on the card (J <= 2): the factor adjoint's state at every row,
    ``MX (C, N, J, J)`` (the state entering row n for n >= 1, the state
    after every step at row 0), in blocks of ``block_len`` rows (default
    :func:`factor_adjoint_block_len`)."""
    C, N, J = U.shape
    inputs = (p, U, W, bv0, bdp)
    _check("factor_rev", inputs, _row_shapes(C, N, J, 4, 1))
    MX = _empty(p, C, N, J, J)
    L = _block_len("factor_rev", block_len, N, factor_adjoint_block_len)
    D = J * J
    _two_level("factor_rev", J, inputs, (MX,), C, N, L, D * D + D, D)
    return MX


def frev_maps_cuda(p, U, W, bv0, bdp, block_len=None):
    """K4 on the card, in blocks of ``block_len`` rows (default
    :func:`structured_block_len`) and groups of :data:`FUSED_GROUP`
    blocks: each block's suffix within its group ``suffix (C, NB, E)``
    (the composition of its map and those of the group's later blocks)
    and each group's map ``groups (C, GB, E)``, as affine maps (E =
    J^4 + J^2: the linear part row-major, then the constant).  With one
    block, nothing is launched and both are None: K5 walks it alone."""
    C, N, J = U.shape
    inputs = (p, U, W, bv0, bdp)
    _check("frev_maps", inputs, _row_shapes(C, N, J, 4, 1))
    if min(C, N) < 1:
        raise ValueError(f"frev_maps: empty system (C={C}, N={N})")
    L = _block_len("frev_maps", block_len, N,
                   lambda n: structured_block_len(n, C))
    NB = -(-N // L)
    if NB == 1:
        return None, None
    E = J**4 + J * J
    outs = (_empty(p, C, NB, E), _empty(p, C, -(-NB // FUSED_GROUP), E))
    _launch_general("frev_maps", J, inputs, outs, (C, N, L))
    return outs


def frev_states_cuda(p, U, W, bv0, bdp, suffix, groups, block_len=None):
    """K5 on the card: from K4's ``suffix`` and ``groups``
    (:func:`frev_maps_cuda`, None with one block), the factor adjoint's
    state entering every row, ``MX (C, N, J, J)``, by the scan over the
    groups (with more than one) and the rows; the blocks are of
    ``block_len`` rows (default :func:`structured_block_len`), those
    of K4's call."""
    C, N, J = U.shape
    inputs = (p, U, W, bv0, bdp)
    _check("frev_states", inputs, _row_shapes(C, N, J, 4, 1))
    if min(C, N) < 1:
        raise ValueError(f"frev_states: empty system (C={C}, N={N})")
    L = _block_len("frev_states", block_len, N,
                   lambda n: structured_block_len(n, C))
    D = J * J
    NB = -(-N // L)
    GB = -(-NB // FUSED_GROUP)
    if NB > 1:
        _check("frev_states", (p, suffix, groups),
               ((C, N, J), (C, NB, D * D + D), (C, GB, D * D + D)))
    elif suffix is not None or groups is not None:
        raise ValueError("frev_states: one block takes no suffix or groups")
    MX = _empty(p, C, N, J, J)
    gstates = _empty(p, C, GB, D) if GB > 1 else None
    _launch_general("frev_states", J, (*inputs, suffix, groups),
                    (MX, gstates), (C, N, L))
    LAUNCHES["frev_states"] += GB > 1
    return MX


def _launch_general(key, J, inputs, outs, ints, fn=None, launched=None):
    """Launch ``c2t_<fn>`` (``fn`` defaults to ``key``; csrc/general_ops.cu,
    csrc/assoc_prefix.cu, csrc/fused_loglik.cu) on ``inputs``
    into ``outs`` (None for an array that is not given or not wanted: its
    pointer is null), with the
    trailing integer arguments ``ints``, and count it under ``key``.  ``J``
    None is not passed (a kernel that takes its width from ``ints``).  With
    ``launched`` (a ``ctypes.c_int``), the function reports through it the
    kernels it launched, and those are counted."""
    widths = WIDTHS.get(key.split(":")[0], (J,))
    if J is not None and J not in widths:
        raise NotImplementedError(f"{key}: J must be one of {widths}, got {J}")
    x = inputs[0]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"c2t_{fn or key}")(
            int(x.dtype == torch.float64),
            *(() if J is None else (J,)),
            *(None if t is None else t.data_ptr() for t in (*inputs, *outs)),
            *ints,
            *(() if launched is None else (ctypes.byref(launched),)),
            stream,
        )
    LAUNCHES[key] += 1 if launched is None else launched.value
    if rc != 0:
        raise RuntimeError(f"{key}: kernel launch failed (CUDA error {rc})")


def _empty(like, *shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def factor_fwd_cuda(p, a, U, V, want_cache=False):
    """The factor kernel on the card: ``d (C, N)``, ``W (C, N, J)`` and,
    if ``want_cache``, ``S_half (C, N, J, J)`` (else None)."""
    C, N, J = U.shape
    inputs = (p, a, U, V)
    _check("factor_fwd", inputs, ((C, N, J), (C, N), (C, N, J), (C, N, J)))
    if min(C, N) < 1:
        raise ValueError(f"factor_fwd: empty system (C={C}, N={N})")
    outs = (
        _empty(p, C, N),
        _empty(p, C, N, J),
        _empty(p, C, N, J, J) if want_cache else None,
    )
    _launch_general("factor_fwd", J, inputs, outs, (C, N))
    return outs


def sweep_fwd_cuda(p, A, B, Y, is_solve, upper, want_cache=False):
    """The sweep kernel on the card: ``Z (C, N, K)`` and, if
    ``want_cache``, ``F (C, N, J, K)`` (else None)."""
    C, N, J = A.shape
    K = Y.shape[-1]
    inputs = (p, A, B, Y)
    _check("sweep_fwd", inputs, ((C, N, J),) * 3 + ((C, N, K),))
    if min(C, N, K) < 1:
        raise ValueError(f"sweep_fwd: empty system (C={C}, N={N}, K={K})")
    outs = (_empty(p, C, N, K), _empty(p, C, N, J, K) if want_cache else None)
    _launch_general(
        "sweep_fwd", J, inputs, outs, (C, N, K, int(is_solve), int(upper))
    )
    return outs


def factor_bwd_cuda(p, d, U, W, S_half, bd, bW):
    """The factor adjoint kernel on the card: ``ba (C, N)``, ``bU``,
    ``bV`` and ``bp (C, N, J)`` from the forward's ``d``, ``W`` and cache
    ``S_half (C, N, J, J)`` and the cotangents ``bd (C, N)``, ``bW (C, N,
    J)``."""
    C, N, J = U.shape
    inputs = (p, d, U, W, S_half, bd, bW)
    _check("factor_bwd", inputs, ((C, N, J), (C, N), (C, N, J), (C, N, J),
                                  (C, N, J, J), (C, N), (C, N, J)))
    if min(C, N) < 1:
        raise ValueError(f"factor_bwd: empty system (C={C}, N={N})")
    outs = (_empty(p, C, N), _empty(p, C, N, J), _empty(p, C, N, J),
            _empty(p, C, N, J))
    _launch_general("factor_bwd", J, inputs, outs, (C, N))
    return outs


# the row kernels built on the tile ring, in the order c2t_ring numbers them
RING_KERNELS = ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd")


def ring(name, dtype, J, K=1, C=1, cache=False, is_solve=True):
    """``(rows per tile, chains per block, bytes of shared memory)`` of the
    ring of the row kernel ``name`` (one of :data:`RING_KERNELS`) for C
    chains of ``dtype`` at width J and K right-hand sides (the sweeps), as
    the built library plans it on the current card.  The forward kernels'
    plans depend on their optional output tile: ``factor_fwd``'s cache, and
    ``sweep_fwd``'s F, which goes through it with the cache or in a matmul
    (``is_solve`` False)."""
    if name not in RING_KERNELS:
        raise ValueError(f"ring: {name!r} is not one of {RING_KERNELS}")
    with_out = cache or (name == "sweep_fwd" and not is_solve)
    chains, nbytes = ctypes.c_int(0), ctypes.c_longlong(0)
    rows = _library().c2t_ring(
        int(dtype == torch.float64), J, RING_KERNELS.index(name), K, C,
        int(with_out), ctypes.byref(chains), ctypes.byref(nbytes))
    if rows == 0:
        raise NotImplementedError(f"rings: no width J = {J}")
    if rows < 0:
        raise RuntimeError(f"rings: CUDA error {-rows}")
    return rows, chains.value, nbytes.value


def sweep_bwd_cuda(p, A, B, R, F, bZ, is_solve, upper):
    """The sweep adjoint kernel on the card: ``bA, bB, bp (C, N, J)`` and
    ``bY (C, N, K)`` from the rows ``R (C, N, K)`` that fed the forward
    carry (Z for a solve, Y for a matmul), its cache ``F (C, N, J, K)``
    and the cotangent ``bZ``."""
    C, N, J = A.shape
    K = bZ.shape[-1]
    inputs = (p, A, B, R, F, bZ)
    _check("sweep_bwd", inputs,
           ((C, N, J),) * 3 + ((C, N, K), (C, N, J, K), (C, N, K)))
    if min(C, N, K) < 1:
        raise ValueError(f"sweep_bwd: empty system (C={C}, N={N}, K={K})")
    outs = (*(_empty(p, C, N, J) for _ in range(3)), _empty(p, C, N, K))
    _launch_general(
        "sweep_bwd", J, inputs, outs, (C, N, K, int(is_solve), int(upper))
    )
    return outs


def affine_run_len(M):
    """Rows a lane walks in the diagonal-affine prefix (a tile is 32 runs):
    16, from ``chip_smoke.py --sweep`` on an H100 80GB HBM3 at 700 W
    (float64, runs of 1 to 32 rows; PERF.md, PR 13).  Where the card is
    full 16 rows were the fastest: M = 1e5, J = 8 with 64 chains (0.486 ms;
    8 rows 0.541, 32 0.572) or K = 64 (0.470; 8 rows 0.513, 32 0.509), and
    M = 1e6 (0.118; 8 rows 0.141).  At one chain and K = 1 a call takes the
    host's launch time, 0.07-0.09 ms, at every length from 2 rows.  Every
    length holds the row recurrence to 2.6e-15."""
    return 16


def affine_prefix_cuda(phi, G, reverse=False, block_len=None):
    """The diagonal-affine prefix on the card: ``F (C, M, J, K)`` with
    ``F[m] = phi[m] F[m -+ 1] + G[m]`` over the rows (descending with
    ``reverse``).

    One launch (csrc/assoc_prefix.cu, ``affine_prefix_kernel``): a
    single-pass scan with decoupled look-back over tiles of 32 runs of
    ``block_len`` rows (default :func:`affine_run_len`; a power of two up
    to 32), each lane a run.  The status words of the tiles and the
    ticket that orders them are allocated here, zeroed, beside the tiles'
    aggregates and inclusive values."""
    C, M, J, K = G.shape
    _check("affine_prefix", (phi, G), ((C, M, J), (C, M, J, K)))
    if min(C, M, J, K) < 1:
        raise ValueError(f"affine_prefix: empty system {tuple(G.shape)}")
    run = affine_run_len(M) if block_len is None else int(block_len)
    if run not in (1, 2, 4, 8, 16, 32):
        raise ValueError(
            f"affine_prefix: rows a run must be a power of two up to 32, got {run}")
    n_status = _library().c2t_affine_status(C, M, J, K, run)
    status = torch.zeros(n_status, dtype=torch.int32, device=G.device)
    values = _empty(G, 3 * (n_status - 1))
    F = torch.empty_like(G)
    _launch_general("affine_prefix", None, (phi, G), (F, status, values),
                    (C, M, J, K, run, int(reverse)))
    return F


def kalman_block_len(N, J):
    """Rows per block of the Riccati and Kalman prefixes on the card, for
    digits first, time second (``chip_smoke.py --sweep`` on an H100 80GB
    HBM3 at 700 W, float64, K = 1, blocks of 16 to 4096 rows; errors of
    chain 0, relative to the largest entry).

    * J <= 4: no digits lost at any length (S and F within 1.3e-13 of the
      row recursion, 7.5e-14 of the same recursion in long double), so
      K1's rule, :func:`fused_block_len`: 32 rows at N = 1e5 (one chain,
      J = 4: Riccati 0.158 ms, Kalman 0.164; 64 rows 0.177, 0.257), 128 at
      N = 1e6 (0.36, 0.51; 64 rows 0.29, 0.54; 256 rows 0.55, 0.86).  At 64
      chains the rule's lengths lie within 11% of the fastest swept one.
    * J = 8: 2048 rows.  Short blocks lose digits at wide8's stiff
      Q = 0.5 term (ROADMAP C4): from 16 to 256 rows S and F lie 1.8e-9 to
      3.9e-8 from the long double recursion at N = 1e5 and 1e6.  From 512
      rows they lie within 3.7e-10 (S) and 6.5e-10 (F) of it, as close as
      the float64 row recursion itself (3.4e-10 to 4.0e-10, 4.7e-10 to
      6.0e-10), so against that recursion the two errors add: 512 rows
      reach 1.03e-9 (F at N = 1e6, the 64-chain data) and 1024 rows
      1.10e-9, past the 1e-9 gate.  2048 and 4096 rows keep every swept
      shape (1 and 64 chains, N = 1e5 and 1e6) under 8.5e-10 and 7.4e-10
      against it; 2048 is the faster (2.05 ms at N = 1e5, one chain).
    * J >= 16: 512 rows, measured at N = 1e5, one chain only: J = 16 S, F
      within 2.5e-10 of the row recursion (1.77 ms; 128 rows 1.49 at
      5.0e-10), J = 32 within 7.6e-11 (5.71 ms; 256 rows 5.17 at
      1.8e-10)."""
    if J <= 4:
        return fused_block_len(N)
    return 2048 if J == 8 else 512


def _riccati_prev(name, prev, C, J, like):
    """The row before each chain's row 0, ``(a (C,), U (C, J), V (C, J))``,
    checked (None: row 0's element is the identity)."""
    if prev is None:
        return (None, None, None)
    prev = tuple(prev)
    _check(name, (like, *prev), (tuple(like.shape), (C,), (C, J), (C, J)))
    return prev


def kalman_prefix_cuda(p, a, U, V, Y=None, block_len=None, *, prev=None,
                       S0=None):
    """The Riccati prefix (``Y`` None) or the Kalman prefix on the card.

    The element of row n >= 1 is built from row n - 1 and ``p[n]``
    (``assoc.factor_assoc``, ``factor_solve_assoc``), that of row 0 is the
    identity; returns the state after every row applied to zero: ``S (C,
    N, J, J)``, and with ``Y (C, N, K)`` also ``F (C, N, J, K)``.

    The Riccati prefix may start from an incoming state, as one shard of a
    sequence split over ranks does: ``prev = (a (C,), U (C, J), V (C, J))``,
    the row before each chain's row 0, whose element row 0 then is (with
    ``p[:, 0]``), and ``S0 (C, J, J)``, the state entering the chain; the
    kernels take both where they start from the identity and zero.  A
    launch with ``S0`` counts under ``riccati_prefix:carry``.

    The rows go in blocks of ``block_len`` (default
    :func:`kalman_block_len`), the blocks in groups (csrc/assoc_prefix.cu,
    ``c2t_riccati_group``): one launch walks the rows of one block; with
    more blocks, a two-level scan.  At J <= 4 that is three launches (two
    with one group): each block's map and its prefix within the group, the
    scan over the groups, and every block's rows again from the state
    entering it.  From J = 8 five (three with one group): the map of every
    block, the map of every group, the state entering every group, the
    state entering every block, and the rows.  Each kernel launched counts
    in :data:`LAUNCHES`."""
    C, N, J = U.shape
    kalman = Y is not None
    K = Y.shape[-1] if kalman else 0
    key = "kalman_prefix" if kalman else "riccati_prefix"
    shapes = [(C, N, J), (C, N), (C, N, J), (C, N, J)]
    _check(key, (p, a, U, V) + ((Y,) if kalman else ()),
           shapes + ([(C, N, K)] if kalman else []))
    if min(C, N) < 1 or (kalman and K < 1):
        raise ValueError(f"{key}: empty system (C={C}, N={N}, K={K})")
    if kalman and (prev is not None or S0 is not None):
        raise ValueError("kalman_prefix: no incoming state (prev, S0)")
    prev = _riccati_prev(key, prev, C, J, p)
    if S0 is not None:
        _check(key, (p, S0), ((C, N, J), (C, J, J)))
    L = kalman_block_len(N, J) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    S = _empty(p, C, N, J, J)
    F = _empty(p, C, N, J, K) if kalman else None
    n_work = _library().c2t_riccati_work(J, C, N, K, L)  # -1 for another J
    work = _empty(p, n_work) if n_work > 0 else None
    _launch_general(key if S0 is None else f"{key}:carry", J,
                    (p, a, U, V, Y, *prev, S0), (S, F, work),
                    (C, N, K, L), "riccati_prefix", ctypes.c_int(0))
    return (S, F) if kalman else S


def riccati_prefix_cuda(p, a, U, V, block_len=None, *, prev=None, S0=None):
    """The Riccati prefix on the card: ``S (C, N, J, J)``
    (:func:`kalman_prefix_cuda` without right-hand sides)."""
    return kalman_prefix_cuda(p, a, U, V, None, block_len, prev=prev, S0=S0)


def riccati_total_cuda(p, a, U, V, block_len=None, *, prev=None):
    """The total map of each chain's Riccati elements on the card, ``(A, Q,
    R)`` each ``(C, J, J)``: the composition of every row's element (row
    0's from ``prev``, as in :func:`kalman_prefix_cuda`, else the
    identity), without the rows' states.  The blocks' maps (one launch),
    then the level over them: at J <= 4 one more launch with more than one
    group of blocks; from J = 8 one a level of groups of maps until one is
    left (``c2t_riccati_total``).  Counted under ``riccati_total``."""
    C, N, J = U.shape
    _check("riccati_total", (p, a, U, V),
           ((C, N, J), (C, N), (C, N, J), (C, N, J)))
    if min(C, N) < 1:
        raise ValueError(f"riccati_total: empty system (C={C}, N={N})")
    prev = _riccati_prev("riccati_total", prev, C, J, p)
    L = kalman_block_len(N, J) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"riccati_total: block length must be >= 1, got {L}")
    total = _empty(p, C, 3, J, J)
    n_work = _library().c2t_riccati_total_work(J, C, N, L)
    work = _empty(p, n_work) if n_work > 0 else None
    _launch_general("riccati_total", J, (p, a, U, V, *prev), (total, work),
                    (C, N, L), launched=ctypes.c_int(0))
    return total.unbind(1)


def mat_affine_block_len(M, D):
    """Rows per block of the matrix-affine prefix on the card up to
    D = 32, for digits first, time second (``chip_smoke.py --sweep`` on
    the lower solve's elements, H100 80GB HBM3 at 700 W, float64, K = 1,
    8 to 2048 rows; PERF.md, PR 13).

    * D <= 4: K1's rule, :func:`fused_block_len` (32 rows at M = 1e5, 128
      at 1e6): every length keeps 1.8e-15 of the row recursion, and the
      rule's length was the fastest or within 10% of it at J = 2, 4 with
      1 and 64 chains (J = 4, one chain, M = 1e5: 0.116 ms, 16 rows 0.108).
    * 4 < D <= 8: the same, but at least 128 rows.  Short blocks lose
      digits at wide8's stiff Q = 0.5 term: 6.0e-10 at 8 rows, 3.0e-10 at
      32, 1.0e-10 at 64 and 3.7e-11 at 128 (M = 1e5; 4.0e-10 at 32 and
      5.4e-11 at 128 at M = 1e6), against a float64 recursion 2.6e-12 to
      4.4e-12 from the long double one; at M = 1e4, 32 rows miss the 1e-10
      gate (1.4e-10).  128 rows cost time at one chain and M = 1e5 (0.281
      ms, 32 rows 0.124) and are the fastest with 64 chains (2.918 ms) and
      at M = 1e6 (0.560).
    * D > 8: the rule (J = 16, M = 1e5: 5.2e-11 at 32 rows, 0.595 ms, 64
      rows 0.475; J = 32, M = 1e4: 1.4e-13, 0.547 ms, 16 rows 0.479)."""
    L = fused_block_len(M)
    return max(L, 128) if 4 < D <= 8 else L


def _mat_affine_args(key, A, b, block_len):
    C, M, D, K = b.shape
    _check(key, (A, b), ((C, M, D, D), (C, M, D, K)))
    if min(C, M, D, K) < 1:
        raise ValueError(f"{key}: empty system {tuple(b.shape)}")
    L = mat_affine_block_len(M, D) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    return C, M, D, K, L


def mat_affine_prefix_cuda(A, b, reverse=False, block_len=None, *, x0=None):
    """The matrix-affine prefix on the card: the value ``x_m = A_m x_prev +
    b_m`` after every row of ``A (C, M, D, D)``, ``b (C, M, D, K)``,
    starting from ``x0 (C, D, K)`` (None: zero), which enters before the
    first row in walk order; rows descending with ``reverse``.  Returns
    ``(C, M, D, K)``.

    Up to D = 32 a two-level scan in one call of ``c2t_mat_affine_prefix``
    (csrc/assoc_prefix.cu), in blocks of ``block_len`` rows (default
    :func:`mat_affine_block_len`) and groups of blocks: one launch walks
    the rows of one block; with more blocks, each block's map and its
    prefix within its group, then (with more than one group) the scan over
    the groups, then every block's rows from the value entering it.  Above
    D = 32 one launch walks all the rows (phase B of the factor adjoint:
    few rows, large maps).  Each kernel launched counts in
    :data:`LAUNCHES`, under ``mat_affine_prefix:carry`` with ``x0``."""
    C, M, D, K, L = _mat_affine_args("mat_affine_prefix", A, b, block_len)
    if x0 is not None:
        _check("mat_affine_prefix", (b, x0), ((C, M, D, K), (C, D, K)))
    F = torch.empty_like(b)
    n_work = _library().c2t_mat_affine_work(D, C, M, K, L, 0)
    work = _empty(b, n_work) if n_work > 0 else None
    key = "mat_affine_prefix" if x0 is None else "mat_affine_prefix:carry"
    _launch_general(key, None, (A, b, x0), (F, work), (C, M, D, K, L, int(reverse)),
                    "mat_affine_prefix", ctypes.c_int(0))
    return F


def mat_affine_total_cuda(A, b, reverse=False, block_len=None):
    """The total map of each chain's rows on the card, ``(P (C, D, D), q
    (C, D, K))`` with ``x_last = P x_in + q`` over the rows in walk order
    (descending with ``reverse``), without the value after every row.  Up
    to D = 32 the blocks' maps and their scan within the groups (one
    launch, also with one block), then the groups' maps composed in order
    (one launch); above, one walk of the D + K columns of ``[P | q]``.
    Counted under ``mat_affine_total``."""
    C, M, D, K, L = _mat_affine_args("mat_affine_total", A, b, block_len)
    P, q = _empty(b, C, D, D), _empty(b, C, D, K)
    n_work = _library().c2t_mat_affine_work(D, C, M, K, L, 1)
    work = _empty(b, n_work) if n_work > 0 else None
    _launch_general("mat_affine_total", None, (A, b), (P, q, work),
                    (C, M, D, K, L, int(reverse)), launched=ctypes.c_int(0))
    return P, q


def _slab_planes(name, t, ndim):
    """Check a float32 batch of planes for the layout kernels."""
    _check(name, (t,), (tuple(t.shape),))
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {t.dtype}")
    if t.dim() != ndim or t.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")


def _launch_layout(name, src, dst, E, R, C):
    """Launch ``c2t_<name>`` (csrc/slab_layout.cu): each of the E planes
    ``(R, C)`` of ``src`` transposed into ``dst``, a thread block a 32 x 32
    tile of a plane; count it."""
    if -(-R // 32) * -(-C // 32) >= 2**31 or max(E, R, C) >= 2**31:
        raise ValueError(f"{name}: planes ({E}, {R}, {C}) are too large")
    lib = _library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = getattr(lib, f"c2t_{name}")(src.data_ptr(), dst.data_ptr(), E, R, C,
                                         stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


def slab_transpose_cuda(x, s):
    """K15 on the card: the float32 planes ``x (E, TOT, LP)`` transposed,
    ``y (E, LP, s, TOT // s)`` with ``y[e, l, i, j] = x[e, i * (TOT // s) +
    j, l]`` (the fused slab's layout at TOT = s * 128).  One launch."""
    _slab_planes("slab_transpose", x, 3)
    E, TOT, LP = x.shape
    if s < 1 or TOT % s:
        raise ValueError(f"slab_transpose: {TOT} rows do not split into s = {s}")
    y = torch.empty(E, LP, s, TOT // s, dtype=x.dtype, device=x.device)
    _launch_layout("slab_transpose", x, y, E, TOT, LP)
    return y


def slab_inverse_cuda(y):
    """K16 on the card: the float32 planes ``y (E, LP, s, W)`` back in rows,
    ``x (E, s * W, LP)``, the inverse of :func:`slab_transpose_cuda`.  One
    launch."""
    _slab_planes("slab_inverse", y, 4)
    E, LP, s, W = y.shape
    x = torch.empty(E, s * W, LP, dtype=y.dtype, device=y.device)
    _launch_layout("slab_inverse", y, x, E, LP, s * W)
    return x
