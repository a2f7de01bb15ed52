"""Eager CPU GaussianProcess over the native C driver.

Counterpart of ``celerite2_tpu/cpu/gp.py``, over this package's terms.
Role of the reference's NumPy backend (python/celerite2/numpy.py): every
call executes the O(N J^2) C recursions at once on NumPy buffers in the
host's memory, in float64.  It is the host driver by design (small-N work
on the host, or an independent oracle), not a stand-in for the card: no
path of :class:`celerite2_torch.GaussianProcess` calls it.  Gradients are
deliberately not provided (the reference's NumPy backend is gradient-free
too); differentiate ``celerite2_torch.gp`` instead.

The terms are this package's: their coefficients and matrices are computed
by the term on its parameters' device and brought to the host as NumPy
arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from celerite2_torch.cpu.bindings import driver
from celerite2_torch.models.terms import Term
from celerite2_torch.utils import LinAlgError

__all__ = ["NumpyGaussianProcess"]

LOG2PI = math.log(2.0 * math.pi)


def _np(x):
    """A C-contiguous float64 host array of ``x`` (a tensor detached)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def _on_host(kernel, method, *arrays):
    """``kernel.method(*arrays)`` with the arrays as float64 tensors on the
    device of the kernel's parameters, each result as a host array."""
    device = kernel.get_coefficients()[0].device
    args = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in arrays)
    out = getattr(kernel, method)(*args)
    return tuple(map(_np, out)) if isinstance(out, tuple) else _np(out)


class NumpyGaussianProcess:
    """Eager GP on the native CPU driver (reference numpy.py surface)."""

    def __init__(self, kernel, t=None, *, mean=0.0, **kwargs):
        self.kernel = kernel
        self.mean = mean if callable(mean) else (lambda x: np.full(np.shape(x), float(mean)))
        self._computed = False
        if t is not None:
            self.compute(t, **kwargs)

    # ------------------------------------------------------- compute
    def _fill_matrices(self, t, diag):
        """Prefer the fused C fill kernel when the kernel exposes plain
        coefficients; terms that override matrix construction (e.g.
        TermConvolution's diagonal correction) go through their own
        method."""
        if type(self.kernel).get_celerite_matrices is not Term.get_celerite_matrices:
            return _on_host(self.kernel, "get_celerite_matrices", t, diag)
        coeffs = tuple(_np(c) for c in self.kernel.get_coefficients())
        return driver.get_celerite_matrices(*coeffs, t, diag)

    def compute(self, t, *, yerr=None, diag=None, check_sorted=True, quiet=False):
        t = _np(t)
        if t.ndim != 1:
            raise ValueError("the input coordinates must be one dimensional")
        if check_sorted and np.any(t[1:] < t[:-1]):
            raise ValueError("the input coordinates must be sorted")
        if yerr is not None and diag is not None:
            raise ValueError("only one of 'diag' and 'yerr' can be provided")
        if yerr is not None:
            diag_v = np.broadcast_to(_np(yerr), t.shape) ** 2
        elif diag is not None:
            diag_v = np.broadcast_to(_np(diag), t.shape)
        else:
            diag_v = np.zeros_like(t)

        self._t = t
        self._diag = np.ascontiguousarray(diag_v)
        self._mean_value = _np(self.mean(t))
        self._c, self._a, self._U, self._V = self._fill_matrices(t, self._diag)
        try:
            self._d, self._W = driver.factor(t, self._c, self._a, self._U, self._V)
            self._ok = True
            self._norm = -0.5 * (np.sum(np.log(self._d)) + len(t) * LOG2PI)
        except LinAlgError:
            if not quiet:
                raise
            self._ok = False
            self._d = np.full(len(t), -1.0)
            self._W = np.zeros_like(self._U)
            self._norm = np.inf
        self._computed = True
        return self

    def recompute(self, *, quiet=False):
        self._require()
        return self.compute(self._t, diag=self._diag, check_sorted=False, quiet=quiet)

    def _require(self):
        if not self._computed:
            raise RuntimeError("you must call 'compute' first")

    def _check_input(self, y, *, vector=False):
        self._require()
        y = _np(y)
        if vector and y.ndim != 1:
            raise ValueError("'y' must be one dimensional")
        if y.shape[0] != self._t.shape[0]:
            raise ValueError("dimension mismatch")
        return y

    # -------------------------------------------------------- solver
    def apply_inverse(self, y):
        y = self._check_input(y)
        z = driver.solve_lower(self._t, self._c, self._U, self._W, y)
        z = z / (self._d if z.ndim == 1 else self._d[:, None])
        return driver.solve_upper(self._t, self._c, self._U, self._W, z)

    def dot_tril(self, y):
        y = self._check_input(y)
        z = np.sqrt(self._d) * y if y.ndim == 1 else np.sqrt(self._d)[:, None] * y
        return z + driver.matmul_lower(self._t, self._c, self._U, self._W, z)

    def log_likelihood(self, y):
        y = self._check_input(y, vector=True)
        if not self._ok:
            return -np.inf
        alpha = driver.solve_lower(self._t, self._c, self._U, self._W,
                                   y - self._mean_value)
        return self._norm - 0.5 * float(np.sum(alpha**2 / self._d))

    # ---------------------------------------------------- prediction
    def _cross(self, kernel, xs, alpha):
        """``K(xs, t) @ alpha`` by the two rectangular products."""
        c, _, U1, V1 = _on_host(kernel, "get_celerite_matrices", self._t,
                                np.zeros_like(self._t))
        _, _, U2, V2 = _on_host(kernel, "get_celerite_matrices", xs, np.zeros_like(xs))
        return (driver.general_matmul_lower(xs, self._t, c, U2, V1, alpha)
                + driver.general_matmul_upper(xs, self._t, c, V2, U1, alpha))

    def predict(self, y, t=None, *, return_var=False, return_cov=False,
                include_mean=True, kernel=None):
        y = self._check_input(y, vector=True)
        alpha = self.apply_inverse(y - self._mean_value)
        xs = self._t if t is None else _np(t)
        use_kernel = kernel or self.kernel

        if t is None and kernel is None:
            mu = y - self._diag * alpha
            if not include_mean:
                mu = mu - self._mean_value
        else:
            mu = self._cross(use_kernel, xs, alpha)
            if include_mean:
                mu = mu + _np(self.mean(xs))

        if not (return_var or return_cov):
            return mu

        # dense cross-covariance tail (reference core.py:52-66 cost)
        KxsT = _on_host(use_kernel, "get_value", self._t[:, None] - xs[None, :])
        Kinv_KxsT = self.apply_inverse(KxsT)
        if return_var:
            k0 = float(_on_host(use_kernel, "get_value", np.zeros(1))[0])
            return mu, k0 - np.sum(KxsT * Kinv_KxsT, axis=0)
        cov = _on_host(use_kernel, "get_value", xs[:, None] - xs[None, :])
        cov -= KxsT.T @ Kinv_KxsT
        return mu, cov

    def condition(self, *args, **kwargs):
        raise NotImplementedError(
            "use predict(...) / sample_conditional(...) on the eager CPU "
            "backend, or celerite2_torch.GaussianProcess for the full "
            "conditional-distribution API"
        )

    def sample_conditional(self, y, t=None, *, size=None, rng=None,
                           include_mean=True, regularize=None):
        """Exact conditional samples at ``t`` via pathwise (Matheron)
        conditioning through the C driver: O(N + M) per draw, no dense
        M x M Cholesky (role of reference core.py:152-179; the same
        construction as ``sample_pathwise``).

        ``regularize`` jitters the joint prior diagonal; required when
        ``t`` duplicates training times (``t=None`` included), where the
        exactly duplicated joint system is singular.  A non-PD joint
        system raises ``LinAlgError``.
        """
        self._require()
        y = self._check_input(y, vector=True)
        rng = np.random.default_rng() if rng is None else rng
        xs = self._t if t is None else _np(t)
        N, M = len(self._t), len(xs)

        # sorted union; stable order keeps duplicates adjacent
        t_all = np.concatenate([self._t, xs])
        order = np.argsort(t_all, kind="stable")
        inv = np.argsort(order, kind="stable")
        t_u = t_all[order]
        pos_train, pos_test = inv[:N], inv[N:]
        diag_u = np.zeros_like(t_u)
        if regularize is not None:
            diag_u += regularize
        c, a, U, V = _on_host(self.kernel, "get_celerite_matrices", t_u, diag_u)
        d_u, W_u = driver.factor(t_u, c, a, U, V)

        # joint latent prior draw(s) f ~ N(0, K_joint)
        S = 1 if size is None else int(size)
        z = rng.standard_normal((N + M, S))
        f = np.sqrt(d_u)[:, None] * z
        f = f + driver.matmul_lower(t_u, c, U, W_u, f)
        f_train, f_test = f[pos_train], f[pos_test]

        # correction through the training factorization
        eps = rng.standard_normal((N, S)) * np.sqrt(self._diag)[:, None]
        resid = (y - self._mean_value)[:, None] - f_train - eps
        samp = f_test + self._cross(self.kernel, xs, self.apply_inverse(resid))
        if include_mean:
            samp = samp + _np(self.mean(xs))[:, None]
        return samp[:, 0] if size is None else samp.T

    # ------------------------------------------------------ sampling
    def sample(self, *, size=None, rng=None, include_mean=True):
        self._require()
        rng = np.random.default_rng() if rng is None else rng
        n = len(self._t)
        shape = (n,) if size is None else (size, n)
        z = rng.standard_normal(shape)
        samp = self.dot_tril(z.T if z.ndim == 2 else z)
        samp = samp.T if z.ndim == 2 else samp
        if include_mean:
            samp = samp + self._mean_value
        return samp

    @property
    def citations(self):
        from celerite2_torch.citation import CITATION_KEYS, get_citations

        return CITATION_KEYS, get_citations()
