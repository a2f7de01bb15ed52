"""The GaussianProcess API.

Counterpart of ``celerite2_tpu/gp.py``:

* a **functional core** (:func:`gp_compute`, :func:`gp_log_likelihood`,
  :func:`gp_apply_inverse`, :func:`gp_dot_tril`, :func:`gp_sample`) on an
  immutable :class:`GPState`, and :func:`gp_loglik`, the sampler's inner
  loop (value and gradient in one fused pass);
* a thin **object shell** (:class:`GaussianProcess`) with the ``compute /
  log_likelihood / predict / condition / dot_tril / apply_inverse /
  sample`` surface, and :class:`ConditionalDistribution`.

Everything runs on the device of ``t``.  A ``t`` that is not yet a tensor
is placed on ``device=`` if given, else on the package default
``Config.device`` (the card); ``y``, ``yerr``, ``diag`` and the kernel's
parameters follow ``t``.

A :class:`GPState` describes ONE system.  ``gp_loglik`` also takes chains:
kernel parameters with a leading chain axis ``(C,)``, ``t (N,)`` or ``(C,
N)`` and ``y (N,)`` or ``(C, N)`` give ``(C,)``.  A system that is not
positive definite gives ``-inf`` (and zero gradients), never NaN; the
shell's ``compute`` raises ``LinAlgError`` instead unless ``quiet``.

Gradients: everything here is differentiable at any J <= 32, with respect
to the kernel's parameters, ``t``, ``y``, ``yerr``/``diag`` and the mean.
``gp_loglik`` runs the fused path at J <= 4 and ``ops.factor_solve`` above;
the state API (``gp_compute``, ``log_likelihood``, ``apply_inverse``,
``dot_tril``, ``predict``, ``sample``) runs on ``ops.factor``, the sweeps
and the rectangular products, each with its hand-derived adjoint.  The
general ops keep their caches (``S_half (N, J, J)`` per chain of the
factor, ``F (N, J, K)`` per sweep) only when a gradient will be asked for.
Not ported yet (ROADMAP.md item A7): the pathwise conditional sampler,
``numpyro_dist`` and ``citations``.  The JAX package's f64 island is a local ``.double()``
here; its batching guard has no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from celerite2_torch import ops
from celerite2_torch.config import get_config
from celerite2_torch.ops.fused_loglik import loglik_fused
from celerite2_torch.utils.misc import LinAlgError, as_tensor, atleast_1d

__all__ = [
    "ConstantMean",
    "GPState",
    "GaussianProcess",
    "ConditionalDistribution",
    "gp_compute",
    "gp_apply_inverse",
    "gp_dot_tril",
    "gp_log_likelihood",
    "gp_loglik",
    "gp_sample",
]

LOG2PI = math.log(2.0 * math.pi)


class ConstantMean:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, x):
        return as_tensor(self.value, like=x).expand(x.shape)


def _rows(x, t):
    """``x`` broadcast against the rows of ``t``."""
    x = as_tensor(x, like=t)
    return x.expand(torch.broadcast_shapes(x.shape, t.shape))


def _diag_and_mean(t, yerr, diag, mean):
    """The observational variance and the mean at the rows of ``t``."""
    if yerr is not None and diag is not None:
        raise ValueError("only one of 'diag' and 'yerr' can be provided")
    if yerr is not None:
        diag_v = _rows(yerr, t) ** 2
    elif diag is not None:
        diag_v = _rows(diag, t)
    else:
        diag_v = torch.zeros_like(t)
    mean_fn = mean if callable(mean) else ConstantMean(mean)
    return diag_v, _rows(mean_fn(t), t)


def _float64_core(t) -> bool:
    return get_config().core_dtype == "float64" and t.dtype != torch.float64


def gp_loglik(kernel, t, y, *, yerr=None, diag=None, mean=0.0, device=None):
    """GP log-likelihood, differentiable with respect to the kernel's
    parameters (and ``t``, ``y``, ``yerr``/``diag``, the mean): the fused
    pass at J <= 4, the factor and lower solve of ``ops.factor_solve``
    (kernels ``factor_fwd``, ``sweep_fwd`` and, for the gradient,
    ``sweep_bwd``, ``factor_bwd``) at any wider J <= 32.

    ``yerr`` adds ``yerr**2`` to the diagonal, ``diag`` adds itself;
    give at most one.  ``mean`` is a constant or a callable of ``t``.
    Under ``Config.core_dtype == "float64"`` the computation runs in
    float64 and the result is cast back to the dtype of ``t``.
    """
    t = atleast_1d(t, device=device)
    diag_v, mean_value = _diag_and_mean(t, yerr, diag, mean)
    resid = as_tensor(y, like=t) - mean_value

    if _float64_core(t):
        ll = _loglik_core(
            kernel.to(torch.float64), t.double(), resid.double(),
            diag_v.double(),
        )
        return ll.to(t.dtype)
    return _loglik_core(kernel, t, resid, diag_v)


def _loglik_core(kernel, t, resid, diag_v):
    c, a, U, V = kernel.get_celerite_matrices(t, diag_v)
    J = U.shape[-1]
    if J < 1:
        raise ValueError("gp_loglik needs a kernel of width J >= 1")
    N = t.shape[-1]
    if resid.shape[-1] != N:
        raise ValueError(f"y must have {N} rows, got {tuple(resid.shape)}")
    batch = torch.broadcast_shapes(c.shape[:-1], resid.shape[:-1], t.shape[:-1])
    if len(batch) > 1:
        raise ValueError(f"at most one chain axis, got batch shape {batch}")
    C = batch[0] if batch else 1
    system = (c.expand(C, J), a.expand(C, N), U.expand(C, N, J),
              V.expand(C, N, J), resid.expand(C, N))
    if J <= 4:
        ll = loglik_fused(t if t.dim() == 1 else t.expand(C, N), *system)
        return ll.reshape(batch)
    # J > 4: the general factor and lower solve (celerite2_tpu/gp.py
    # _loglik_core: ops.factor_solve)
    c, a, U, V, resid = system
    d, _, z = ops.factor_solve(t.expand(C, N), c, a, U, V, resid[..., None])
    ok = (d > 0).all(-1)
    # a chain that is not positive definite gives -inf and zero gradients:
    # its rows leave the sums before they enter them, since a float32 z of
    # such a chain can overflow z^2 / d, and 0 * inf in the backward is NaN
    safe_d = torch.where(ok[..., None], d, torch.ones_like(d))
    z = torch.where(ok[..., None], z[..., 0], torch.zeros_like(d))
    ll = -0.5 * (
        torch.log(safe_d).sum(-1) + (z**2 / safe_d).sum(-1) + N * LOG2PI
    )
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    return ll.reshape(batch)


# ================================================== the functional core


class GPState(NamedTuple):
    """Everything the solver needs after ``compute``, for one system."""

    t: torch.Tensor  # (N,)
    c: torch.Tensor  # (J,)
    a: torch.Tensor  # (N,) original diagonal (incl. observational diag)
    U: torch.Tensor  # (N, J)
    V: torch.Tensor  # (N, J)
    d: torch.Tensor  # (N,) Cholesky diagonal
    W: torch.Tensor  # (N, J) Cholesky low-rank factor
    diag: torch.Tensor  # (N,) observational variance
    mean_value: torch.Tensor  # (N,)
    ok: torch.Tensor  # () bool: positive definite
    log_det: torch.Tensor  # ()
    norm: torch.Tensor  # () = -(log_det + N log 2pi)/2


def _safe(d, fill=1.0):
    return torch.where(d > 0, d, torch.full_like(d, fill))


def gp_compute(kernel, t, *, yerr=None, diag=None, mean=0.0,
               device=None) -> GPState:
    """Build and factorize the GP system.

    Under ``Config.core_dtype == "float64"`` the matrix build and the
    factorization run in float64; the returned state is cast back to the
    dtype of ``t`` (prediction and conditioning then run at the input's
    precision on the accurately computed factors).  A system that is not
    positive definite is not raised here: ``state.ok`` is False,
    ``log_det`` is ``-inf`` and ``norm`` ``+inf`` (the quiet semantics).
    """
    t = atleast_1d(t, device=device)
    if t.dim() != 1:
        raise ValueError("a GPState describes one system: 't' must be (N,)")
    diag_v, mean_value = _diag_and_mean(t, yerr, diag, mean)

    if _float64_core(t):
        c, a, U, V, d, W = (
            x.to(t.dtype)
            for x in _compute_core(
                kernel.to(torch.float64), t.double(), diag_v.double()
            )
        )
    else:
        c, a, U, V, d, W = _compute_core(kernel, t, diag_v)

    ok = (d > 0).all()
    log_det = torch.where(ok, torch.log(_safe(d)).sum(), -math.inf)
    norm = torch.where(ok, -0.5 * (log_det + t.shape[0] * LOG2PI), math.inf)
    return GPState(
        t=t, c=c, a=a, U=U, V=V, d=d, W=W, diag=diag_v,
        mean_value=mean_value, ok=ok, log_det=log_det, norm=norm,
    )


def _compute_core(kernel, t, diag_v):
    c, a, U, V = kernel.get_celerite_matrices(t, diag_v)
    if U.dim() != 2:
        raise ValueError(
            "a GPState describes one system: the kernel's parameters must "
            f"not carry a chain axis (got U of shape {tuple(U.shape)})"
        )
    d, W = ops.factor(t, c, a, U, V)
    return c, a, U, V, d, W


def _as_matrix(y, like):
    y = as_tensor(y, like=like)
    if y.dim() == 1:
        return y[:, None], True
    return y, False


def gp_apply_inverse(state: GPState, y):
    """K^{-1} y = L^{-T} d^{-1} L^{-1} y."""
    Y, is_vec = _as_matrix(y, state.t)
    z = ops.solve_lower(state.t, state.c, state.U, state.W, Y)
    z = z / _safe(state.d)[:, None]
    z = ops.solve_upper(state.t, state.c, state.U, state.W, z)
    return z[:, 0] if is_vec else z


def gp_dot_tril(state: GPState, y):
    """x = L diag(sqrt(d)) y, so that x x^T averages to K."""
    Y, is_vec = _as_matrix(y, state.t)
    z = torch.sqrt(_safe(state.d, 0.0))[:, None] * Y
    z = z + ops.matmul_lower(state.t, state.c, state.U, state.W, z)
    return z[:, 0] if is_vec else z


def gp_log_likelihood(state: GPState, y):
    """norm - alpha^T d^{-1} alpha / 2 with alpha = L^{-1} (y - mean), and
    the quiet -inf on systems that are not positive definite."""
    resid = (as_tensor(y, like=state.t) - state.mean_value)[:, None]
    alpha = ops.solve_lower(state.t, state.c, state.U, state.W, resid)[:, 0]
    ll = state.norm - 0.5 * (alpha**2 / _safe(state.d)).sum()
    return torch.where(state.ok, ll, -math.inf)


def _randn(shape, like, generator):
    """Standard normals of ``like``'s dtype on its device, drawn on the
    generator's own device (a CPU generator serves a CUDA state)."""
    device = like.device if generator is None else generator.device
    z = torch.randn(shape, generator=generator, dtype=like.dtype, device=device)
    return z.to(like.device)


def gp_sample(state: GPState, generator=None, *, shape=(), include_mean=True):
    """Prior samples via L sqrt(d) z.  ``generator`` is a
    ``torch.Generator`` (in place of the JAX package's key; None draws from
    PyTorch's global generator)."""
    shape = tuple(shape)
    n = state.t.shape[0]
    z = _randn(shape + (n,), state.t, generator)
    samp = gp_dot_tril(state, z.reshape(-1, n).T).T.reshape(shape + (n,))
    if include_mean:
        samp = samp + state.mean_value
    return samp


def _cross_dot(kernel, t_train, xs, inp):
    """``K*(xs, t_train) @ inp`` via the rectangular semiseparable ops."""
    c, _, U1, V1 = kernel.get_celerite_matrices(t_train, torch.zeros_like(t_train))
    _, _, U2, V2 = kernel.get_celerite_matrices(xs, torch.zeros_like(xs))
    inp2, is_vec = _as_matrix(inp, t_train)
    z = ops.general_matmul_lower(
        xs, t_train, c, U2, V1, inp2
    ) + ops.general_matmul_upper(xs, t_train, c, V2, U1, inp2)
    return z[:, 0] if is_vec else z


# ======================================================== conditional


class ConditionalDistribution:
    """The conditional (predictive) distribution.

    The mean uses the O(N + M) semiseparable path; ``variance`` and
    ``covariance`` build the dense N x M cross-covariance, a documented
    O(N M) cost.
    """

    def __init__(self, gp, y, t=None, *, include_mean=True, kernel=None):
        self.gp = gp
        st = gp._state
        self.y = as_tensor(y, like=st.t)
        self.t = None if t is None else torch.atleast_1d(as_tensor(t, like=st.t))
        if self.t is not None and self.t.dim() != 1:
            raise ValueError("'t' must be one-dimensional")
        self.include_mean = include_mean
        self.kernel = kernel
        self._xs = st.t if self.t is None else self.t

    # -------------------------------------------------- dense pieces
    @property
    def KxsT(self):
        kernel = self.kernel or self.gp.kernel
        tau = self.gp._state.t[:, None] - self._xs[None, :]
        return kernel.get_value(tau)

    @property
    def Kinv_KxsT(self):
        return self.gp.apply_inverse(self.KxsT)

    # ----------------------------------------------------- the mean
    def _alpha(self):
        st = self.gp._state
        return self.gp.apply_inverse(self.y - st.mean_value)

    def _do_dot(self, inp):
        kernel = self.kernel or self.gp.kernel
        return _cross_dot(kernel, self.gp._state.t, self._xs, inp)

    @property
    def mean(self):
        st = self.gp._state
        alpha = self._alpha()

        if self.t is None and self.kernel is None:
            # fast O(N) path: mu = y - diag * alpha
            mu = self.y - st.diag * alpha
            if not self.include_mean:
                mu = mu - st.mean_value
            return mu

        mu = self._do_dot(alpha)
        if self.include_mean:
            mu = mu + as_tensor(self.gp._mean(self._xs), like=mu)
        return mu

    @property
    def variance(self):
        kernel = self.kernel or self.gp.kernel
        KxsT = self.KxsT
        k0 = kernel.get_value(self._xs.new_zeros(1))[0]
        return k0 - (KxsT * self.gp.apply_inverse(KxsT)).sum(0)

    @property
    def covariance(self):
        kernel = self.kernel or self.gp.kernel
        cov = kernel.get_value(self._xs[:, None] - self._xs[None, :])
        return cov - self._do_dot(self.Kinv_KxsT)

    def sample(self, generator=None, *, shape=(), regularize=None):
        """Sample the conditional through the dense M x M Cholesky factor
        of its covariance; O(M^3)."""
        mu = self.mean
        cov = self.covariance
        if regularize is not None:
            cov = cov + regularize * torch.eye(
                cov.shape[0], dtype=cov.dtype, device=cov.device
            )
        chol = torch.linalg.cholesky(cov)
        z = _randn(tuple(shape) + (cov.shape[0],), cov, generator)
        return mu + z @ chol.mT


# ============================================================ the shell


class GaussianProcess:
    """User-facing GP object.

    The functional core is exposed too: ``gp.state`` after ``compute``,
    and the module-level ``gp_*`` functions.  ``device`` is where inputs
    that are not yet tensors are placed (default ``Config.device``).
    """

    conditional_distribution = ConditionalDistribution

    def __init__(self, kernel, t=None, *, mean=0.0, device=None, **kwargs):
        self.kernel = kernel
        self.mean = mean
        self.device = device
        self._state: Optional[GPState] = None
        if t is not None:
            self.compute(t, **kwargs)

    # -------------------------------------------------------- mean
    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, mean):
        self._mean = mean if callable(mean) else ConstantMean(mean)

    @property
    def mean_value(self):
        self._require_computed()
        return self._state.mean_value

    @property
    def state(self) -> GPState:
        self._require_computed()
        return self._state

    # ------------------------------------------------------ compute
    def compute(
        self, t, *, yerr=None, diag=None, check_sorted=True, quiet=False
    ):
        t = atleast_1d(t, device=self.device)
        if t.dim() != 1:
            raise ValueError("The input coordinates must be one dimensional")
        if check_sorted and bool((t[1:] < t[:-1]).any()):
            raise ValueError("The input coordinates must be sorted")
        self._state = gp_compute(
            self.kernel, t, yerr=yerr, diag=diag, mean=self._mean
        )
        if not quiet and not bool(self._state.ok):
            raise LinAlgError(
                "failed to factorize or solve matrix; the system is "
                "not positive definite (use quiet=True for -inf "
                "log-likelihood semantics)"
            )
        return self

    def recompute(self, *, quiet=False):
        """Re-factorize with the stored inputs."""
        self._require_computed()
        st = self._state
        return self.compute(
            st.t, diag=st.diag, check_sorted=False, quiet=quiet
        )

    def _require_computed(self):
        if self._state is None:
            raise RuntimeError("you must call 'compute' first")

    def _process_input(self, y, *, require_vector=False):
        self._require_computed()
        y = as_tensor(y, like=self._state.t)
        if require_vector and y.dim() != 1:
            raise ValueError("'y' must be one dimensional")
        if y.dim() == 0 or y.shape[0] != self._state.t.shape[0]:
            raise ValueError("dimension mismatch")
        return y

    # ------------------------------------------------------- solver
    def apply_inverse(self, y, **_ignored):
        y = self._process_input(y)
        return gp_apply_inverse(self._state, y)

    def dot_tril(self, y, **_ignored):
        y = self._process_input(y)
        return gp_dot_tril(self._state, y)

    def log_likelihood(self, y, **_ignored):
        y = self._process_input(y, require_vector=True)
        return gp_log_likelihood(self._state, y)

    # --------------------------------------------------- prediction
    def predict(
        self,
        y,
        t=None,
        *,
        return_cov=False,
        return_var=False,
        include_mean=True,
        kernel=None,
    ):
        cond = self.condition(
            y, t=t, include_mean=include_mean, kernel=kernel
        )
        if return_var:
            return cond.mean, cond.variance
        if return_cov:
            return cond.mean, cond.covariance
        return cond.mean

    def condition(self, y, t=None, *, include_mean=True, kernel=None):
        y = self._process_input(y, require_vector=True)
        return self.conditional_distribution(
            self, y, t=t, include_mean=include_mean, kernel=kernel
        )

    # ----------------------------------------------------- sampling
    def sample(self, generator=None, *, size=None, include_mean=True):
        self._require_computed()
        shape = () if size is None else (size,)
        return gp_sample(
            self._state, generator, shape=shape, include_mean=include_mean
        )

    @property
    def citations(self):
        """``(CITATION_KEYS, BibTeX)`` for the celerite method papers."""
        from celerite2_torch.citation import CITATION_KEYS, get_citations

        return CITATION_KEYS, get_citations()
