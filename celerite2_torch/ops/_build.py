"""Build, bind and launch the hand-written CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (Hopper) at first
use into ``celerite2_torch/_build/`` (ignored by git), as a shared
library with a plain C interface, and bound with ``ctypes``.  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt, and a process that builds at the same time as another
never loads a half-written file.

Each wrapper checks its tensors (CUDA, one device, float32 or float64,
contiguous, the expected shapes), allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch failed, and counts the launch in :data:`LAUNCHES`.
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
    "kalman_fwd_cuda",
    "solve_rev_cuda",
    "factor_rev_cuda",
    "frev_maps_cuda",
    "frev_states_cuda",
    "factor_fwd_cuda",
    "sweep_fwd_cuda",
    "factor_bwd_cuda",
    "sweep_bwd_cuda",
    "adjoint_ring",
    "affine_prefix_cuda",
    "riccati_prefix_cuda",
    "kalman_prefix_cuda",
    "mat_affine_prefix_cuda",
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
# kernel, so a run can show that its main path went through them).
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
    "kalman_prefix": 0,
    "mat_affine_prefix": 0,
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
        # (is_double, J, inputs..., outputs..., C, N, L, stream)
        for name, n_arrays in (
            ("c2t_kalman_fwd", 7),
            ("c2t_solve_rev", 6),
            ("c2t_factor_rev", 7),
            ("c2t_frev_maps", 6),
            ("c2t_frev_states", 7),
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
        # (is_double, J, K, C, is_sweep, chains, bytes)
        lib.c2t_adjoint_ring.argtypes = [I] * 5 + [P] * 2
        lib.c2t_adjoint_ring.restype = I
        # (is_double, J, phi, G, carry, F, tot_a, tot_b, C, M, K, L, reverse,
        #  stream)
        lib.c2t_affine_prefix.argtypes = [I, I] + [P] * 6 + [I] * 5 + [P]
        lib.c2t_affine_prefix.restype = I
        # (is_double, J, p, a, U, V, Y, S, F, tA, tQ, tR, tb, teta, cS, cF,
        #  C, N, K, L, phase, stream)
        lib.c2t_riccati_prefix.argtypes = [I, I] + [P] * 14 + [I] * 5 + [P]
        lib.c2t_riccati_prefix.restype = I
        # (is_double, A, b, carry, F, last, P, Pw, C, M, D, K, L, reverse,
        #  phase, stream)
        lib.c2t_mat_affine_prefix.argtypes = [I] + [P] * 7 + [I] * 7 + [P]
        lib.c2t_mat_affine_prefix.restype = I
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


def _num_blocks(key, J, N, L):
    """Blocks of L rows in N, after checking that the kernel is built for
    width J and that L is a block length."""
    if J not in WIDTHS[key]:
        raise NotImplementedError(
            f"{key}: J must be one of {WIDTHS[key]}, got {J}"
        )
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    return -(-N // L)


def _launch(key, inputs, out_shapes, C, N, J, L):
    """Launch ``c2t_<key>`` on ``inputs`` into new outputs of
    ``out_shapes``; returns the outputs."""
    x = inputs[0]
    outs = [torch.empty(s, dtype=x.dtype, device=x.device) for s in out_shapes]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"c2t_{key}")(
            int(x.dtype == torch.float64),
            J,
            *(t.data_ptr() for t in (*inputs, *outs)),
            C,
            N,
            L,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{key}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[key] += 1
    return outs


def _row_shapes(C, N, J, n_vec, n_scalar):
    return ((C, N, J),) * n_vec + ((C, N),) * n_scalar


def kalman_fwd_cuda(p, U, V, ainv, y, L):
    """K1 on the card: per-row Kalman prefixes ``(C, N, 3J^2+2J)`` and
    block maps ``(C, ceil(N/L), 3J^2+2J)``."""
    C, N, J = U.shape
    NB = _num_blocks("kalman_fwd", J, N, L)
    inputs = (p, U, V, ainv, y)
    _check("kalman_fwd", inputs, _row_shapes(C, N, J, 3, 2))
    E = 3 * J * J + 2 * J
    return tuple(
        _launch("kalman_fwd", inputs, ((C, N, E), (C, NB, E)), C, N, J, L)
    )


def solve_rev_cuda(p, U, W, bz, L):
    """K2 on the card: per-row suffix maps ``(C, N, J^2+J)`` and block
    maps ``(C, ceil(N/L), J^2+J)``."""
    C, N, J = U.shape
    NB = _num_blocks("solve_rev", J, N, L)
    inputs = (p, U, W, bz)
    _check("solve_rev", inputs, _row_shapes(C, N, J, 3, 1))
    E = J * J + J
    return tuple(
        _launch("solve_rev", inputs, ((C, N, E), (C, NB, E)), C, N, J, L)
    )


def factor_rev_cuda(p, U, W, bv0, bdp, L):
    """K3 on the card: per-row suffix maps ``(C, N, J^4+J^2)`` and block
    maps ``(C, ceil(N/L), J^4+J^2)``."""
    C, N, J = U.shape
    NB = _num_blocks("factor_rev", J, N, L)
    inputs = (p, U, W, bv0, bdp)
    _check("factor_rev", inputs, _row_shapes(C, N, J, 4, 1))
    E = J**4 + J * J
    return tuple(
        _launch("factor_rev", inputs, ((C, N, E), (C, NB, E)), C, N, J, L)
    )


def frev_maps_cuda(p, U, W, bv0, bdp, L):
    """K4 on the card: each block's composed reverse-factor map
    ``(C, ceil(N/L), J^4+J^2)``, column k of its linear part at
    ``[k J^2, (k+1) J^2)`` and its constant last."""
    C, N, J = U.shape
    NB = _num_blocks("frev_maps", J, N, L)
    inputs = (p, U, W, bv0, bdp)
    _check("frev_maps", inputs, _row_shapes(C, N, J, 4, 1))
    (maps,) = _launch("frev_maps", inputs, ((C, NB, J**4 + J * J),), C, N, J, L)
    return maps


def frev_states_cuda(p, U, W, bv0, bdp, seeds, L):
    """K5 on the card: the reverse-factor state entering every row,
    ``(C, N, J^2)``, each block started from its seed in ``seeds``
    ``(C, ceil(N/L), J^2)``."""
    C, N, J = U.shape
    NB = _num_blocks("frev_states", J, N, L)
    inputs = (p, U, W, bv0, bdp, seeds)
    _check("frev_states", inputs, _row_shapes(C, N, J, 4, 1) + ((C, NB, J * J),))
    (out,) = _launch("frev_states", inputs, ((C, N, J * J),), C, N, J, L)
    return out


def _launch_general(key, J, inputs, outs, ints, fn=None):
    """Launch ``c2t_<fn>`` (``fn`` defaults to ``key``; csrc/general_ops.cu,
    csrc/assoc_prefix.cu) on ``inputs`` into ``outs`` (None for an array
    that is not given or not wanted: its pointer is null), with the
    trailing integer arguments ``ints``, and count it under ``key``.  ``J``
    None is not passed (a kernel that takes its width from ``ints``)."""
    if J is not None and J not in WIDTHS.get(key, (J,)):
        raise NotImplementedError(
            f"{key}: J must be one of {WIDTHS[key]}, got {J}"
        )
    x = inputs[0]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"c2t_{fn or key}")(
            int(x.dtype == torch.float64),
            *(() if J is None else (J,)),
            *(None if t is None else t.data_ptr() for t in (*inputs, *outs)),
            *ints,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{key}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[key] += 1


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


def adjoint_ring(dtype, J, K=1, C=1, sweep=False):
    """``(rows per tile, chains per block, bytes of shared memory)`` of the
    ring of ``factor_bwd`` (or, with ``sweep``, ``sweep_bwd`` at K
    right-hand sides) for C chains of ``dtype`` at width J, as the built
    library plans it on the current card."""
    chains, nbytes = ctypes.c_int(0), ctypes.c_longlong(0)
    rows = _library().c2t_adjoint_ring(
        int(dtype == torch.float64), J, K, C, int(sweep), ctypes.byref(chains),
        ctypes.byref(nbytes))
    if rows == 0:
        raise NotImplementedError(f"adjoint rings: no width J = {J}")
    if rows < 0:
        raise RuntimeError(f"adjoint rings: CUDA error {-rows}")
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


def prefix_block_len(M):
    """Rows per block of the affine prefix: the power of two at or above
    sqrt(M) (at least 32), so that the blocks are at most as many as the
    rows of one block and the recurrence over the blocks is one launch."""
    L = 32
    while L * L < M:
        L *= 2
    return L


def affine_prefix_cuda(phi, G, reverse=False, block_len=None):
    """The affine prefix on the card: ``F (C, M, J, K)`` with ``F[m] =
    phi[m] F[m -+ 1] + G[m]`` over the rows (descending with ``reverse``).

    Up to ``block_len`` rows (default :func:`prefix_block_len`) it is one
    launch.  Above, three: the composed map of every block of ``block_len``
    rows, this function on those maps for the value leaving every block,
    and the rows of every block from the value entering it."""
    C, M, J, K = G.shape
    _check("affine_prefix", (phi, G), ((C, M, J), (C, M, J, K)))
    if min(C, M, J, K) < 1:
        raise ValueError(f"affine_prefix: empty system {tuple(G.shape)}")
    L = prefix_block_len(M) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"affine_prefix: block length must be >= 1, got {L}")
    def launch(carry, F, tot_a, tot_b, L):
        _launch_general("affine_prefix", J, (phi, G), (carry, F, tot_a, tot_b),
                        (C, M, K, L, int(reverse)))

    F = torch.empty_like(G)
    if M <= L:
        launch(None, F, None, None, M)
        return F
    NB = -(-M // L)
    totals = (_empty(G, C, NB, J), _empty(G, C, NB, J, K))
    launch(None, None, *totals, L)
    carry = affine_prefix_cuda(*totals, reverse, L)
    launch(carry, F, None, None, L)
    return F


def kalman_block_len(N):
    """Rows per block of the Riccati and Kalman prefixes: the power of two
    at or above 4 sqrt(N) (at least 32).  Fewer, longer blocks than
    :func:`prefix_block_len`: each block map the carry walk composes costs a
    Gauss-Jordan solve and loses digits (at N = 1e4, J = 8, blocks of 128
    rows put the solve state 1e-10 from the row recursion, blocks of 512
    2e-11), while a row of the apply walk costs three barriers."""
    L = 32
    while L * L < 16 * N:
        L *= 2
    return L


def kalman_prefix_cuda(p, a, U, V, Y=None, block_len=None):
    """The Riccati prefix (``Y`` None) or the Kalman prefix on the card.

    The element of row n >= 1 is built from row n - 1 and ``p[n]``
    (``assoc.factor_assoc``, ``factor_solve_assoc``), that of row 0 is the
    identity; returns the state after every row applied to zero: ``S (C,
    N, J, J)``, and with ``Y (C, N, K)`` also ``F (C, N, J, K)``.

    Up to ``block_len`` rows (default :func:`kalman_block_len`) one launch
    walks them; above, three: the map of every block, the walk over the
    block maps for the state entering every block, and every block's rows
    from that state."""
    C, N, J = U.shape
    kalman = Y is not None
    K = Y.shape[-1] if kalman else 0
    key = "kalman_prefix" if kalman else "riccati_prefix"
    shapes = [(C, N, J), (C, N), (C, N, J), (C, N, J)]
    _check(key, (p, a, U, V) + ((Y,) if kalman else ()),
           shapes + ([(C, N, K)] if kalman else []))
    if min(C, N) < 1 or (kalman and K < 1):
        raise ValueError(f"{key}: empty system (C={C}, N={N}, K={K})")
    L = kalman_block_len(N) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    NB = -(-N // L)
    S = _empty(p, C, N, J, J)
    F = _empty(p, C, N, J, K) if kalman else None
    maps = [None] * 5
    carry = [None, None]
    if NB > 1:
        maps = [_empty(p, C, NB, J, J) for _ in range(3)]
        maps += [_empty(p, C, NB, J, K) if kalman else None for _ in range(2)]
        carry = [_empty(p, C, NB, J, J), _empty(p, C, NB, J, K) if kalman else None]
        for phase in (0, 1):
            _launch_general(key, J, (p, a, U, V, Y), (None, None, *maps, *carry),
                            (C, N, K, L, phase), "riccati_prefix")
    _launch_general(key, J, (p, a, U, V, Y), (S, F, *maps, *carry),
                    (C, N, K, L, 2), "riccati_prefix")
    return (S, F) if kalman else S


def riccati_prefix_cuda(p, a, U, V, block_len=None):
    """The Riccati prefix on the card: ``S (C, N, J, J)``
    (:func:`kalman_prefix_cuda` without right-hand sides)."""
    return kalman_prefix_cuda(p, a, U, V, None, block_len)


def mat_affine_prefix_cuda(A, b, reverse=False, block_len=None):
    """The matrix-affine prefix on the card: the value ``x_m = A_m x_prev +
    b_m`` after every row of ``A (C, M, D, D)``, ``b (C, M, D, K)``,
    starting from zero; rows descending with ``reverse``.  Returns ``(C, M,
    D, K)``.

    Up to ``block_len`` rows (default :func:`prefix_block_len`) it is one
    launch.  Above, four: the product of every block's linear parts, every
    block's walk from zero, this function on those block maps for the
    value leaving every block, and every block's rows from the value
    entering it."""
    C, M, D, K = b.shape
    _check("mat_affine_prefix", (A, b), ((C, M, D, D), (C, M, D, K)))
    if min(C, M, D, K) < 1:
        raise ValueError(f"mat_affine_prefix: empty system {tuple(b.shape)}")
    L = prefix_block_len(M) if block_len is None else int(block_len)
    if L < 1:
        raise ValueError(f"mat_affine_prefix: block length must be >= 1, got {L}")

    def launch(phase, carry, F, last, P, Pw, L):
        _launch_general("mat_affine_prefix", None, (A, b, carry),
                        (F, last, P, Pw), (C, M, D, K, L, int(reverse), phase))

    F = torch.empty_like(b)
    if M <= L:
        launch(1, None, F, None, None, None, M)
        return F
    NB = -(-M // L)
    P, Pw = _empty(b, C, NB, D, D), _empty(b, C, NB, D, D)
    launch(0, None, None, None, P, Pw, L)
    last = _empty(b, C, NB, D, K)
    launch(1, None, None, last, None, None, L)
    carry = mat_affine_prefix_cuda(P, last, reverse, L)
    launch(1, carry, F, None, None, None, L)
    return F
