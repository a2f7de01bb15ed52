"""The GP log-likelihood: the sampler's inner loop.

Counterpart of ``celerite2_tpu/gp.py`` (``ConstantMean``, ``gp_loglik``
and ``_loglik_core``).  The rest of the JAX package's GP layer
(``gp_compute``, prediction, sampling, the ``GaussianProcess`` shell) is
not ported yet (ROADMAP.md item A7).

Kernel parameters may carry a leading chain axis ``(C,)``; ``t`` may be
``(N,)`` or ``(C, N)`` and ``y`` ``(N,)`` or ``(C, N)``.  The result is a
scalar for one system and ``(C,)`` for C chains.  A system that is not
positive definite gives ``-inf`` (and zero gradients), never NaN.
"""

from __future__ import annotations

import torch

from celerite2_torch.config import get_config
from celerite2_torch.ops.fused_loglik import loglik_fused
from celerite2_torch.utils.misc import as_tensor, atleast_1d

__all__ = ["ConstantMean", "gp_loglik"]


class ConstantMean:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, x):
        return as_tensor(self.value, like=x).expand(x.shape)


def _rows(x, t):
    """``x`` broadcast against the rows of ``t``."""
    x = as_tensor(x, like=t)
    return x.expand(torch.broadcast_shapes(x.shape, t.shape))


def gp_loglik(kernel, t, y, *, yerr=None, diag=None, mean=0.0):
    """GP log-likelihood, differentiable with respect to the kernel's
    parameters (and ``t``, ``y``, ``yerr``/``diag``, the mean).

    ``yerr`` adds ``yerr**2`` to the diagonal, ``diag`` adds itself;
    give at most one.  ``mean`` is a constant or a callable of ``t``.
    Under ``Config.core_dtype == "float64"`` the computation runs in
    float64 and the result is cast back to the dtype of ``t``.
    """
    t = atleast_1d(t)
    if yerr is not None and diag is not None:
        raise ValueError("only one of 'diag' and 'yerr' can be provided")
    if yerr is not None:
        diag_v = _rows(yerr, t) ** 2
    elif diag is not None:
        diag_v = _rows(diag, t)
    else:
        diag_v = torch.zeros_like(t)
    mean_fn = mean if callable(mean) else ConstantMean(mean)
    resid = as_tensor(y, like=t) - _rows(mean_fn(t), t)

    if get_config().core_dtype == "float64" and t.dtype != torch.float64:
        ll = _loglik_core(
            kernel.to(torch.float64), t.double(), resid.double(),
            diag_v.double(),
        )
        return ll.to(t.dtype)
    return _loglik_core(kernel, t, resid, diag_v)


def _loglik_core(kernel, t, resid, diag_v):
    c, a, U, V = kernel.get_celerite_matrices(t, diag_v)
    J = U.shape[-1]
    if not 1 <= J <= 4:
        raise NotImplementedError(
            f"gp_loglik supports kernels of width J = 1..4 so far, got "
            f"J={J}: wider kernels wait for ROADMAP.md items A3/A8"
        )
    N = t.shape[-1]
    if resid.shape[-1] != N:
        raise ValueError(f"y must have {N} rows, got {tuple(resid.shape)}")
    batch = torch.broadcast_shapes(c.shape[:-1], resid.shape[:-1], t.shape[:-1])
    if len(batch) > 1:
        raise ValueError(f"at most one chain axis, got batch shape {batch}")
    C = batch[0] if batch else 1
    ll = loglik_fused(
        t if t.dim() == 1 else t.expand(C, N),
        c.expand(C, J),
        a.expand(C, N),
        U.expand(C, N, J),
        V.expand(C, N, J),
        resid.expand(C, N),
    )
    return ll.reshape(batch)
