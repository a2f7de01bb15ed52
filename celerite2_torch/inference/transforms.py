"""Parameter transforms for unconstrained sampling.

Counterpart of ``celerite2_tpu/inference/transforms.py``, on batched
tensors: ``x`` is ``(..., dim)`` and each log-Jacobian is ``(...)``.  GP
hyperparameters are positive (S0, w0, Q, sigma, rho, ...); samplers work
in log-space.  Each transform maps unconstrained -> constrained and
supplies the log-Jacobian correction.
"""

from __future__ import annotations

import torch

__all__ = ["LogTransform", "IdentityTransform", "transform_logdensity"]


class IdentityTransform:
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def log_det_jacobian(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


class LogTransform:
    """y = exp(x): unconstrained x -> positive y; log|dy/dx| = sum(x)."""

    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def log_det_jacobian(self, x):
        return x.sum(dim=-1)


def transform_logdensity(logdensity_fn, transform):
    """Wrap a constrained log-density into unconstrained space."""

    def wrapped(x):
        y = transform.forward(x)
        return logdensity_fn(y) + transform.log_det_jacobian(x)

    return wrapped
