"""The GaussianProcess API.

Counterpart of ``celerite2_tpu/gp.py``:

* a **functional core** (:func:`gp_compute`, :func:`gp_log_likelihood`,
  :func:`gp_apply_inverse`, :func:`gp_dot_tril`, :func:`gp_sample`,
  :func:`gp_sample_conditional`) on an immutable :class:`GPState`, and
  :func:`gp_loglik`, the sampler's inner loop (value and gradient in one
  fused pass);
* a thin **object shell** (:class:`GaussianProcess`) with the ``compute /
  log_likelihood / predict / condition / dot_tril / apply_inverse /
  sample`` surface, and :class:`ConditionalDistribution` with its exact
  draws (the dense ``sample`` and the pathwise ``sample_pathwise``).

Everything runs on the device of ``t``.  A ``t`` that is not yet a tensor
is placed on ``device=`` if given, else on the package default
``Config.device`` (the card); ``y``, ``yerr``, ``diag`` and the kernel's
parameters follow ``t``.

Chains: kernel parameters with a leading chain axis ``(C,)``, and ``t``
as ``(N,)`` or ``(C, N)``, give C systems at once (the JAX package vmaps
its functions over a stack of states instead).  ``gp_loglik`` then gives
``(C,)``; ``gp_compute`` gives one :class:`GPState` whose fields carry the
axis, and the functional core takes it in one call (``y`` as ``(N,)``,
shared, or ``(C, N)``).  The shell, ``variance`` and ``covariance`` stay
one system, as in the JAX package.  A system that is not positive
definite gives ``-inf`` (and zero gradients), never NaN; the shell's
``compute`` raises ``LinAlgError`` instead unless ``quiet``.

Draws come from a ``torch.Generator`` where the JAX package takes a key.
:func:`gp_sample_conditional` and ``sample_pathwise`` draw the joint
prior's normals, then the complement's (for a component conditional), then
the observation noise's, from one generator; the JAX package splits its
key three ways: the same law, another stream (ROADMAP D8).

Gradients: everything here is differentiable at any J <= 32, with respect
to the kernel's parameters, ``t``, ``y``, ``yerr``/``diag`` and the mean.
``gp_loglik`` runs the fused path at J <= 4 and ``ops.factor_solve`` above;
the state API runs on ``ops.factor``, the sweeps and the rectangular
products, each with its hand-derived adjoint.  The general ops keep their
caches (``S_half (N, J, J)`` per chain of the factor, ``F (N, J, K)`` per
sweep) only when a gradient will be asked for.  ``numpyro_dist``'s
counterpart is :meth:`GaussianProcess.distribution` (a
``torch.distributions.Distribution``).  The JAX package's f64 island is a
local ``.double()`` here; its batching guard has no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from celerite2_torch import ops
from celerite2_torch.config import get_config
from celerite2_torch.models.terms import TermSum
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
    "gp_sample_conditional",
]

LOG2PI = math.log(2.0 * math.pi)


class ConstantMean:
    """A constant mean: a number, or a ``(C,)`` tensor of one number a
    chain, which gives ``(C, M)`` at ``M`` points."""

    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, x):
        value = as_tensor(self.value, like=x)
        if value.dim() == 0:
            return value.expand(x.shape)
        value = value[..., None]
        return value.expand(torch.broadcast_shapes(value.shape, x.shape))


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
    """Everything the solver needs after ``compute``: one system, or C
    systems with a leading chain axis on the fields that carry it."""

    t: torch.Tensor  # (N,), or (C, N) when each chain has its own times
    c: torch.Tensor  # (J,) or (C, J)
    a: torch.Tensor  # (N,) or (C, N): the diagonal, observational one included
    U: torch.Tensor  # (N, J) or (C, N, J)
    V: torch.Tensor  # (N, J) or (C, N, J)
    d: torch.Tensor  # (N,) or (C, N): the Cholesky diagonal
    W: torch.Tensor  # (N, J) or (C, N, J): the Cholesky low-rank factor
    diag: torch.Tensor  # the observational variance, broadcast against t
    mean_value: torch.Tensor  # the mean at t: (N,) or (C, N)
    ok: torch.Tensor  # () or (C,) bool: positive definite
    log_det: torch.Tensor  # () or (C,)
    norm: torch.Tensor  # () or (C,): -(log_det + N log 2pi) / 2


def _safe(d, fill=1.0):
    return torch.where(d > 0, d, torch.full_like(d, fill))


def _chains_of(state):
    """``()`` for one system, ``(C,)`` for a chain-axis state."""
    return state.d.shape[:-1]


def _times(state):
    """The state's times with its chain axis."""
    return state.t.expand(state.d.shape)


def gp_compute(kernel, t, *, yerr=None, diag=None, mean=0.0,
               device=None) -> GPState:
    """Build and factorize the GP system: one, or C of them when the
    kernel's parameters carry a chain axis ``(C,)`` or ``t`` is ``(C, N)``.

    Under ``Config.core_dtype == "float64"`` the matrix build and the
    factorization run in float64; the returned state is cast back to the
    dtype of ``t`` (prediction and conditioning then run at the input's
    precision on the accurately computed factors).  A system that is not
    positive definite is not raised here: ``state.ok`` is False,
    ``log_det`` is ``-inf`` and ``norm`` ``+inf`` (the quiet semantics).
    """
    t = atleast_1d(t, device=device)
    if t.dim() > 2:
        raise ValueError("'t' must be (N,) or, for C systems, (C, N)")
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

    ok = (d > 0).all(-1)
    log_det = torch.where(ok, torch.log(_safe(d)).sum(-1), -math.inf)
    norm = torch.where(ok, -0.5 * (log_det + t.shape[-1] * LOG2PI), math.inf)
    return GPState(
        t=t, c=c, a=a, U=U, V=V, d=d, W=W, diag=diag_v,
        mean_value=mean_value, ok=ok, log_det=log_det, norm=norm,
    )


def _system(kernel, t, diag, chains=()):
    """``(t, c, a, U, V)`` of the kernel at ``t``, with the chain axis of
    the kernel, of ``t`` or of ``chains`` on each."""
    c, a, U, V = kernel.get_celerite_matrices(t, diag)
    chains = torch.broadcast_shapes(chains, U.shape[:-2])
    if len(chains) > 1:
        raise ValueError(f"at most one chain axis, got batch shape {chains}")
    N, J = U.shape[-2:]
    return (t.expand(*chains, N), c.expand(*chains, J), a.expand(*chains, N),
            U.expand(*chains, N, J), V.expand(*chains, N, J))


def _compute_core(kernel, t, diag_v):
    t, c, a, U, V = _system(kernel, t, diag_v)
    d, W = ops.factor(t, c, a, U, V)
    return c, a, U, V, d, W


def _as_matrix(y, like, chains=()):
    """``y`` as right-hand sides ``(*chains, N, K)``, and whether it was
    one vector.  With a chain axis ``y`` is ``(N,)`` (shared), ``(C, N)``
    or ``(C, N, K)``."""
    y = as_tensor(y, like=like)
    is_vec = y.dim() in (1, len(chains) + 1)
    Y = y[..., None] if is_vec else y
    return Y.expand(*chains, *Y.shape[-2:]), is_vec


def gp_apply_inverse(state: GPState, y):
    """K^{-1} y = L^{-T} d^{-1} L^{-1} y."""
    Y, is_vec = _as_matrix(y, state.t, _chains_of(state))
    t = _times(state)
    z = ops.solve_lower(t, state.c, state.U, state.W, Y)
    z = z / _safe(state.d)[..., None]
    z = ops.solve_upper(t, state.c, state.U, state.W, z)
    return z[..., 0] if is_vec else z


def _dot_tril(t, c, U, d, W, Y):
    """L diag(sqrt(d)) Y; a non-positive pivot contributes nothing."""
    z = torch.sqrt(_safe(d, 0.0))[..., None] * Y
    return z + ops.matmul_lower(t, c, U, W, z)


def gp_dot_tril(state: GPState, y):
    """x = L diag(sqrt(d)) y, so that x x^T averages to K."""
    Y, is_vec = _as_matrix(y, state.t, _chains_of(state))
    z = _dot_tril(_times(state), state.c, state.U, state.d, state.W, Y)
    return z[..., 0] if is_vec else z


def gp_log_likelihood(state: GPState, y):
    """norm - alpha^T d^{-1} alpha / 2 with alpha = L^{-1} (y - mean), and
    the quiet -inf on systems that are not positive definite."""
    resid = (as_tensor(y, like=state.t) - state.mean_value).expand(state.d.shape)
    return _log_likelihoods(state, resid[..., None])[..., 0]


def _log_likelihoods(state, R):
    """The log-likelihood of each residual column of ``R (*chains, N,
    K)``: ``(*chains, K)``."""
    alpha = ops.solve_lower(_times(state), state.c, state.U, state.W, R)
    quad = (alpha**2 / _safe(state.d)[..., None]).sum(-2)
    ll = state.norm[..., None] - 0.5 * quad
    return torch.where(state.ok[..., None], ll, -math.inf)


def _randn(shape, like, generator):
    """Standard normals of ``like``'s dtype on its device, drawn on the
    generator's own device (a CPU generator serves a CUDA state)."""
    device = like.device if generator is None else generator.device
    z = torch.randn(shape, generator=generator, dtype=like.dtype, device=device)
    return z.to(like.device)


def _columns(x, chains):
    """Draws ``(*chains, *shape, N)`` as right-hand sides ``(*chains, N,
    prod(shape))``."""
    return x.reshape(*chains, -1, x.shape[-1]).mT


def _draws(Z, chains, shape):
    """Right-hand sides ``(*chains, N, prod(shape))`` as draws ``(*chains,
    *shape, N)``."""
    return Z.mT.reshape(*chains, *shape, Z.shape[-2])


def _rows_for(x, shape):
    """A row vector ``(N,)`` or ``(C, N)`` broadcast against draws ``(C,
    *shape, N)``."""
    if x.dim() < 2:
        return x
    return x.reshape(*x.shape[:-1], *(1,) * len(shape), x.shape[-1])


def gp_sample(state: GPState, generator=None, *, shape=(), include_mean=True):
    """Prior samples via L sqrt(d) z: ``(*shape, N)``, or ``(C, *shape,
    N)`` from a chain-axis state.  ``generator`` is a ``torch.Generator``
    (in place of the JAX package's key; None draws from PyTorch's global
    generator)."""
    shape = tuple(shape)
    chains = _chains_of(state)
    z = _randn(chains + shape + state.d.shape[-1:], state.t, generator)
    samp = _draws(gp_dot_tril(state, _columns(z, chains)), chains, shape)
    if include_mean:
        samp = samp + _rows_for(state.mean_value, shape)
    return samp


def _cross_dot(kernel, t_train, xs, inp):
    """``K*(xs, t_train) @ inp`` via the rectangular semiseparable ops; with
    a chain axis on the kernel, ``t_train`` or ``xs``, ``inp`` is ``(C,
    N)`` or ``(C, N, K)``."""
    t2, c, _, U1, V1 = _system(kernel, t_train, torch.zeros_like(t_train),
                               xs.shape[:-1])
    chains = c.shape[:-1]
    t1, _, _, U2, V2 = _system(kernel, xs, torch.zeros_like(xs), chains)
    inp2, is_vec = _as_matrix(inp, t_train, chains)
    z = ops.general_matmul_lower(
        t1, t2, c, U2, V1, inp2
    ) + ops.general_matmul_upper(t1, t2, c, V2, U1, inp2)
    return z[..., 0] if is_vec else z


# ================================================== pathwise sampling


def _complement_kernel(full, component):
    """The kernel ``full - component`` when it is derivable: ``full`` must
    be a :class:`~celerite2_torch.models.terms.TermSum` holding
    ``component`` (by identity) as one of its summands, possibly nested.
    The component pathwise conditional needs an independent draw from the
    rest of the kernel (the dense path never does: it forms the M x M
    covariance)."""
    if component is full:
        return None
    if not isinstance(full, TermSum):
        raise ValueError(
            "pathwise component conditionals need the complement kernel "
            "(full - kernel); it is derived automatically only when the "
            "GP kernel is a sum containing `kernel` as a summand — pass "
            "complement= explicitly otherwise"
        )
    rest = []
    found = 0
    for sub in full.terms:
        if sub is component:
            found += 1
        elif isinstance(sub, TermSum) and any(
                x is component for x in _flat_terms(sub)):
            inner = _complement_kernel(sub, component)
            if inner is not None:
                rest.append(inner)
            found += 1
        else:
            rest.append(sub)
    if found != 1:
        raise ValueError(
            "could not uniquely identify `kernel` as a summand of the "
            "GP kernel; pass complement= explicitly"
        )
    if not rest:
        raise ValueError(
            "`kernel` IS the full kernel; drop kernel= for the "
            "full-kernel conditional"
        )
    return rest[0] if len(rest) == 1 else TermSum(*rest)


def _flat_terms(term):
    if isinstance(term, TermSum):
        out = []
        for sub in term.terms:
            out.extend(_flat_terms(sub))
        return out
    return [term]


def _union(t, xs):
    """The sorted union of the training times and the targets, and where
    each lands in it: ``(t_u, pos_train, pos_test)``.  The stable sort keeps
    equal times in (train, test) order.  Shared ``t (N,)`` and ``xs (M,)``
    give one union; a chain axis on either gives one a chain, from one
    batched sort and gather."""
    chains = torch.broadcast_shapes(t.shape[:-1], xs.shape[:-1])
    N = t.shape[-1]
    t_all = torch.cat([t.expand(*chains, N), xs.expand(*chains, xs.shape[-1])], -1)
    order = torch.argsort(t_all, dim=-1, stable=True)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    return torch.take_along_dim(t_all, order, -1), inv[..., :N], inv[..., N:]


def _at(f, pos, shape):
    """``f (..., *shape, L)`` at the positions ``pos`` (``(P,)`` or ``(C,
    P)``) of its last axis."""
    if pos.dim() == 1:
        return f[..., pos]
    return torch.take_along_dim(f, _rows_for(pos, shape), -1)


def _prior_draw(kernel, t, diag, Z, chains):
    """``L sqrt(d) Z`` for the prior of ``kernel`` at ``t``: ``Z (*chains,
    N, K)`` standard normals."""
    t, c, a, U, V = _system(kernel, t, diag, chains)
    d, W = ops.factor(t, c, a, U, V)
    return _dot_tril(t, c, U, d, W, Z)


def _pathwise_core(state, kernel, y, xs, z, eps, *, regularize=None,
                   complement=None, z_comp=None):
    """Pathwise (Matheron) conditional draws as a function of the noise:
    ``f* + K(xs, t) (K_tt + S)^{-1} (y - m - f_t - e)`` with ``(f_t, f*)``
    one joint latent prior draw over the sorted union of training and
    target times (an O((N + M) J^2) semiseparable factor) and ``e =
    sqrt(diag) * eps``.  The mean at ``xs`` is not included.

    ``z (*chains, *shape, N + M)``, ``eps (*chains, *shape, N)`` and
    ``z_comp (*chains, *shape, N)`` are standard normals; the draws come
    back as ``(*chains, *shape, M)``.

    Component conditionals (``complement`` not None): ``kernel`` is the
    component K1 and ``complement`` the rest K2, K = K1 + K2.  The joint
    K1 prior gives ``(g_t, g*)``; an independent ``h_t ~ N(0, K2(t, t))``
    (from ``z_comp``) completes the training side, so that ``g_t + h_t +
    e`` has the covariance ``K_tt + S`` and ``Cov(g*, g_t + h_t) = K1(xs,
    t)``: the law of the dense component conditional.
    """
    chains = _chains_of(state)
    shape = eps.shape[len(chains):-1]

    # the joint prior has no observational diagonal (``regularize``
    # jitters it: duplicated times make it singular)
    t_u, pos_train, pos_test = _union(state.t, xs)
    diag_u = torch.zeros_like(t_u)
    if regularize is not None:
        diag_u = diag_u + regularize
    f = _prior_draw(kernel, t_u, diag_u, _columns(z, chains), chains)
    f = _draws(f, chains, shape)
    f_train, f_test = _at(f, pos_train, shape), _at(f, pos_test, shape)

    if complement is not None:
        diag_c = torch.zeros_like(state.t)
        if regularize is not None:
            diag_c = diag_c + regularize
        h = _prior_draw(complement, state.t, diag_c, _columns(z_comp, chains),
                        chains)
        f_train = f_train + _draws(h, chains, shape)

    # the correction K(xs, t) (K_tt + S)^{-1} (y - m - f_t - e)
    noise = eps * _rows_for(torch.sqrt(state.diag), shape)
    resid = _rows_for(as_tensor(y, like=state.t) - state.mean_value, shape)
    alpha = gp_apply_inverse(state, _columns(resid - f_train - noise, chains))
    corr = _cross_dot(kernel, state.t, xs, alpha)
    return f_test + _draws(corr, chains, shape)


def gp_sample_conditional(state, kernel, y, t_new, generator=None, *,
                          shape=(), mean=0.0, regularize=None,
                          complement=None):
    """Exact conditional draws at ``t_new``: the functional core of
    :meth:`ConditionalDistribution.sample_pathwise` (pathwise conditioning,
    O(N + M) a draw, no dense Cholesky).  ``(*shape, M)`` from one system;
    from a chain-axis state (the posterior-predictive fleet: one state a
    theta draw, one call) ``(C, *shape, M)``, with ``y`` and ``t_new`` shared
    or a chain each.

    ``mean`` (a number, a ``(C,)`` tensor or a callable) is the mean at
    ``t_new``; the training mean is in ``state.mean_value``.
    ``regularize`` jitters the joint prior's diagonal, and so biases the
    draws' covariance by the order of ``regularize``.  Where the joint
    prior's pivots fall to float64's resolution (targets that repeat
    training times or lie a hair from them under a smooth kernel), the
    draws keep their law, but the map from the normals to the draws loses
    digits, so two routes give different draws from the same normals.
    Where the factor breaks down (a pivot far below zero, as with a
    near-critical term sampled densely) the draws are not accurate; the
    jitter restores them only at a bias of its own.  Component
    conditionals: pass the component as ``kernel`` and the rest of the
    kernel as ``complement``.

    The normals come from ``generator`` (None: PyTorch's global one) in
    this order: the joint prior's ``z``, the complement's, the noise's
    ``eps``.
    """
    t_new = torch.atleast_1d(as_tensor(t_new, like=state.t))
    chains, shape = _chains_of(state), tuple(shape)
    N, M = state.d.shape[-1], t_new.shape[-1]
    z = _randn(chains + shape + (N + M,), state.t, generator)
    z_comp = None
    if complement is not None:
        z_comp = _randn(chains + shape + (N,), state.t, generator)
    eps = _randn(chains + shape + (N,), state.t, generator)
    samp = _pathwise_core(
        state, kernel, y, t_new, z, eps, regularize=regularize,
        complement=complement, z_comp=z_comp,
    )
    mean_fn = mean if callable(mean) else ConstantMean(mean)
    return samp + _rows_for(as_tensor(mean_fn(t_new), like=samp), shape)


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

    def _one_system(self, what):
        if _chains_of(self.gp._state):
            raise ValueError(
                f"the conditional {what} is dense (N x M) and defined for one "
                "system; a chain-axis state takes the mean and "
                "gp_sample_conditional"
            )

    @property
    def variance(self):
        self._one_system("variance")
        kernel = self.kernel or self.gp.kernel
        KxsT = self.KxsT
        k0 = kernel.get_value(self._xs.new_zeros(1))[0]
        return k0 - (KxsT * self.gp.apply_inverse(KxsT)).sum(0)

    @property
    def covariance(self):
        self._one_system("covariance")
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

    # -------------------------------------------- pathwise sampling
    def _complement(self, complement):
        if self.kernel is not None and complement is None:
            return _complement_kernel(self.gp.kernel, self.kernel)
        return complement

    def _pathwise_transform(self, z, eps, *, regularize=None, z_comp=None,
                            complement=None):
        """The affine map behind :meth:`sample_pathwise`.

        ``z (..., N + M)`` standard normals for the joint latent prior,
        ``eps (..., N)`` for the observation noise (and ``z_comp (...,
        N)`` for the complement's draw on component conditionals) give
        conditional draws ``(..., M)``.  The map is affine in its noise, so
        its Jacobian ``A`` satisfies ``A A^T == covariance`` exactly: the
        tests check the law with no Monte Carlo error."""
        kernel = self.kernel or self.gp.kernel
        st = self.gp._state
        z, eps = as_tensor(z, like=st.t), as_tensor(eps, like=st.t)
        if z_comp is not None:
            z_comp = as_tensor(z_comp, like=st.t)
        samp = _pathwise_core(
            st, kernel, self.y, self._xs, z, eps, regularize=regularize,
            complement=self._complement(complement), z_comp=z_comp,
        )
        if self.include_mean:
            samp = samp + as_tensor(self.gp._mean(self._xs), like=samp)
        return samp

    def sample_pathwise(self, generator=None, *, shape=(), regularize=None,
                        complement=None):
        """Exact conditional draws without the M x M Cholesky factor.

        Pathwise (Matheron's rule) conditioning: draw the joint latent
        prior over the sorted union of training and target times with the
        O((N + M) J^2) semiseparable factor, then shift it by the
        correction from the training factorization::

            f* | y  =  f*  +  K(xs, t) (K_tt + S)^{-1} (y - m - f_t - e)

        with ``(f_t, f*)`` a joint prior draw and ``e ~ N(0, S)``.  The
        draws are exactly ``N(mean, covariance)``, the law of
        :meth:`sample`, at O(N + M) a draw.

        ``regularize`` jitters the joint prior's diagonal, at a bias of
        its order in the draws' covariance (see
        :func:`gp_sample_conditional` for when the draws need it).  A
        component (``kernel=``) conditional draws the joint
        prior from the component and an independent draw of the rest of
        the kernel at the training times; the rest is derived when the GP
        kernel is a sum holding the component as a summand, else pass
        ``complement=``.  The normals come from ``generator`` in the order
        of :func:`gp_sample_conditional`.
        """
        return gp_sample_conditional(
            self.gp._state, self.kernel or self.gp.kernel, self.y, self._xs,
            generator, shape=shape,
            mean=self.gp._mean if self.include_mean else 0.0,
            regularize=regularize, complement=self._complement(complement),
        )


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
        state = gp_compute(
            self.kernel, t, yerr=yerr, diag=diag, mean=self._mean
        )
        if _chains_of(state):
            raise ValueError(
                "a GaussianProcess describes one system: its kernel's "
                "parameters carry a chain axis; use gp_compute and the "
                "gp_* functions for C systems"
            )
        self._state = state
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

    def distribution(self, generator=None, validate_args=None):
        """A ``torch.distributions.Distribution`` over the observations
        (:class:`~celerite2_torch.distributions.CeleriteNormal`; the JAX
        package's ``numpyro_dist``)."""
        from celerite2_torch.distributions import CeleriteNormal

        self._require_computed()
        return CeleriteNormal(self, generator=generator,
                              validate_args=validate_args)

    @property
    def citations(self):
        """``(CITATION_KEYS, BibTeX)`` for the celerite method papers."""
        from celerite2_torch.citation import CITATION_KEYS, get_citations

        return CITATION_KEYS, get_citations()
