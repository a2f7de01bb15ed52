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

__all__ = [
    "LAUNCHES",
    "build",
    "kalman_fwd_cuda",
    "solve_rev_cuda",
    "factor_rev_cuda",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# Launches of each kernel since the last reset (a plain count per
# kernel, so a run can show that its main path went through them).
LAUNCHES = {"kalman_fwd": 0, "solve_rev": 0, "factor_rev": 0}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns its path.  ``<library>.log`` keeps nvcc's output (ptxas
    register and spill counts) and the build time."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libcelerite2_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    start = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    lib.with_suffix(".log").write_text(
        f"build_seconds {seconds:.3f}\n{res.stdout}{res.stderr}"
    )
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        # (is_double, J, inputs..., pre, maps, C, N, L, stream)
        for name, n_in in (
            ("c2t_kalman_fwd", 5),
            ("c2t_solve_rev", 4),
            ("c2t_factor_rev", 5),
        ):
            fn = getattr(lib, name)
            fn.argtypes = [I, I] + [P] * (n_in + 2) + [I, I, I, P]
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


def _launch(key, fn_name, inputs, E, C, N, J, L):
    if J not in (1, 2):
        raise NotImplementedError(f"{key}: J must be 1 or 2, got {J}")
    if L < 1:
        raise ValueError(f"{key}: block length must be >= 1, got {L}")
    NB = -(-N // L)
    x = inputs[0]
    pre = torch.empty(C, N, E, dtype=x.dtype, device=x.device)
    maps = torch.empty(C, NB, E, dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn_name)(
            int(x.dtype == torch.float64),
            J,
            *(t.data_ptr() for t in inputs),
            pre.data_ptr(),
            maps.data_ptr(),
            C,
            N,
            L,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{key}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[key] += 1
    return pre, maps


def kalman_fwd_cuda(p, U, V, ainv, y, L):
    """K1 on the card: per-row Kalman prefixes ``(C, N, 3J^2+2J)`` and
    block maps ``(C, ceil(N/L), 3J^2+2J)``."""
    C, N, J = U.shape
    _check(
        "kalman_fwd",
        (p, U, V, ainv, y),
        ((C, N, J), (C, N, J), (C, N, J), (C, N), (C, N)),
    )
    return _launch(
        "kalman_fwd", "c2t_kalman_fwd", (p, U, V, ainv, y),
        3 * J * J + 2 * J, C, N, J, L,
    )


def solve_rev_cuda(p, U, W, bz, L):
    """K2 on the card: per-row suffix maps ``(C, N, J^2+J)`` and block
    maps ``(C, ceil(N/L), J^2+J)``."""
    C, N, J = U.shape
    _check(
        "solve_rev", (p, U, W, bz), ((C, N, J), (C, N, J), (C, N, J), (C, N))
    )
    return _launch(
        "solve_rev", "c2t_solve_rev", (p, U, W, bz), J * J + J, C, N, J, L
    )


def factor_rev_cuda(p, U, W, bv0, bdp, L):
    """K3 on the card: per-row suffix maps ``(C, N, J^4+J^2)`` and block
    maps ``(C, ceil(N/L), J^4+J^2)``."""
    C, N, J = U.shape
    _check(
        "factor_rev",
        (p, U, W, bv0, bdp),
        ((C, N, J), (C, N, J), (C, N, J), (C, N, J), (C, N)),
    )
    return _launch(
        "factor_rev", "c2t_factor_rev", (p, U, W, bv0, bdp),
        J**4 + J * J, C, N, J, L,
    )
