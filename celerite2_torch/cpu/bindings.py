"""ctypes bindings for the native CPU driver.

Counterpart of ``celerite2_tpu/cpu/bindings.py``, over this package's own
copy of ``driver.cpp``.  The shared library is built with g++ at first use
into ``celerite2_torch/_build/``, under a name that carries a hash of the
source and the flags, so an edit of either builds a new library and a
stale one is never loaded.  The build writes a temporary file and renames
it, so processes that build at once (test workers) do not collide.  A
failed build raises with g++'s output.

The API mirrors the reference driver's in-place NumPy semantics
(python/celerite2/driver.cpp:482-499): outputs are written into
caller-provided arrays and returned.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from celerite2_torch.utils import LinAlgError

__all__ = ["driver", "build", "GXX_FLAGS"]

_SRC = Path(__file__).resolve().parent / "driver.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")
_lock = threading.Lock()
_lib = None

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def build() -> Path:
    """Compile ``driver.cpp`` unless the library for this source and these
    flags exists; returns its path."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes())
    lib = BUILD_DIR / f"libcelerite2_cpu_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({done.returncode}):\n{done.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))

        lib.celerite2_factor.restype = _i64
        lib.celerite2_factor.argtypes = [
            _i64, _i64, _f64, _f64, _f64, _f64, _f64, _f64, _f64,
        ]
        for name in (
            "celerite2_solve_lower",
            "celerite2_solve_upper",
            "celerite2_matmul_lower",
            "celerite2_matmul_upper",
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                _i64, _i64, _i64, _f64, _f64, _f64, _f64, _f64, _f64,
            ]
        for name in (
            "celerite2_general_matmul_lower",
            "celerite2_general_matmul_upper",
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                _i64, _i64, _i64, _i64,
                _f64, _f64, _f64, _f64, _f64, _f64, _f64,
            ]
        lib.celerite2_matrices.restype = None
        lib.celerite2_matrices.argtypes = [
            _i64, _i64, _i64,
            _f64, _f64, _f64, _f64, _f64, _f64,
            _f64, _f64, _f64, _f64, _f64, _f64,
        ]
        _lib = lib
        return _lib


def _c(x):
    """A C-contiguous float64 array of ``x`` (a tensor is detached and
    copied to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


class _Driver:
    """In-place NumPy ops over the native core (reference driver parity)."""

    def factor(self, t, c, a, U, V, d_out=None, W_out=None):
        t, c, a, U, V = map(_c, (t, c, a, U, V))
        N, J = U.shape
        d = d_out if d_out is not None else np.empty(N)
        W = W_out if W_out is not None else np.empty((N, J))
        flag = _get_lib().celerite2_factor(N, J, t, c, a, U, V, d, W)
        if flag:
            raise LinAlgError(f"failed to factorize matrix at row {flag - 1}")
        return d, W

    def _sweep(self, name, t, c, A, B, Y):
        t, c, A, B, Y = map(_c, (t, c, A, B, Y))
        squeeze = Y.ndim == 1
        if squeeze:
            Y = Y[:, None]
        N, J = A.shape
        K = Y.shape[1]
        Z = np.empty_like(Y)
        getattr(_get_lib(), name)(N, J, K, t, c, A, B, Y, Z)
        return Z[:, 0] if squeeze else Z

    def solve_lower(self, t, c, U, W, Y):
        return self._sweep("celerite2_solve_lower", t, c, U, W, Y)

    def solve_upper(self, t, c, U, W, Y):
        return self._sweep("celerite2_solve_upper", t, c, U, W, Y)

    def matmul_lower(self, t, c, U, V, Y):
        return self._sweep("celerite2_matmul_lower", t, c, U, V, Y)

    def matmul_upper(self, t, c, U, V, Y):
        return self._sweep("celerite2_matmul_upper", t, c, U, V, Y)

    def _general(self, name, t1, t2, c, U, V, Y):
        t1, t2, c, U, V, Y = map(_c, (t1, t2, c, U, V, Y))
        squeeze = Y.ndim == 1
        if squeeze:
            Y = Y[:, None]
        N = t1.shape[0]
        M, K = Y.shape
        J = c.shape[0]
        Z = np.empty((N, K))
        getattr(_get_lib(), name)(N, M, J, K, t1, t2, c, U, V, Y, Z)
        return Z[:, 0] if squeeze else Z

    def general_matmul_lower(self, t1, t2, c, U, V, Y):
        return self._general("celerite2_general_matmul_lower", t1, t2, c, U, V, Y)

    def general_matmul_upper(self, t1, t2, c, U, V, Y):
        return self._general("celerite2_general_matmul_upper", t1, t2, c, U, V, Y)

    def get_celerite_matrices(self, ar, cr, ac, bc, cc, dc, x, diag):
        ar, cr, ac, bc, cc, dc, x, diag = map(_c, (ar, cr, ac, bc, cc, dc, x, diag))
        N = x.shape[0]
        Jr, Jc = ar.shape[0], ac.shape[0]
        J = Jr + 2 * Jc
        c = np.empty(J)
        a = np.empty(N)
        U = np.empty((N, J))
        V = np.empty((N, J))
        _get_lib().celerite2_matrices(N, Jr, Jc, ar, cr, ac, bc, cc, dc, x, diag,
                                      c, a, U, V)
        return c, a, U, V


driver = _Driver()
