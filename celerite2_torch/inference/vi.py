"""Mean-field ADVI (automatic differentiation variational inference).

Counterpart of ``celerite2_tpu/inference/vi.py``: a diagonal-Gaussian
variational family with the reparameterization trick, optimised by
``torch.optim.Adam`` (optax's Adam in the JAX package).  The ELBO's draws
are one ``(num_steps, num_mc_samples, dim)`` tensor of standard normals,
drawn up front; the log-density is batched over the draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from celerite2_torch.utils.misc import as_tensor

__all__ = ["ADVIResult", "run_advi"]


class ADVIResult(NamedTuple):
    mean: torch.Tensor  # (dim,) variational mean (unconstrained space)
    log_sigma: torch.Tensor  # (dim,)
    elbo_trace: torch.Tensor  # (num_steps,)

    def sample(self, generator: torch.Generator, shape=()):
        eps = torch.randn(
            tuple(shape) + self.mean.shape, generator=generator,
            dtype=self.mean.dtype, device=self.mean.device,
        )
        return self.mean + torch.exp(self.log_sigma) * eps


def run_advi(
    logdensity_fn: Callable,
    init_params,
    rng,
    *,
    num_steps: int = 2000,
    num_mc_samples: int = 8,
    learning_rate: float = 2e-2,
) -> ADVIResult:
    """Maximize ELBO(q) = E_q[logp] + H[q] for q = N(mu, diag(sigma^2)).

    ``rng``: a ``torch.Generator`` on the device of ``init_params``, from
    which the draws are made, or the draws themselves, standard normals of
    shape ``(num_steps, num_mc_samples, dim)``.
    """
    init_params = as_tensor(init_params)
    dim = init_params.shape[0]
    dtype, device = init_params.dtype, init_params.device
    shape = (num_steps, num_mc_samples, dim)
    if isinstance(rng, torch.Generator):
        draws = torch.randn(shape, generator=rng, dtype=dtype, device=device)
    else:
        draws = as_tensor(rng, like=init_params)
        if draws.shape != shape:
            raise ValueError(f"draws must have shape {shape}, got {tuple(draws.shape)}")

    mu = init_params.detach().clone().requires_grad_(True)
    log_sigma = torch.full((dim,), -2.0, dtype=dtype, device=device,
                           requires_grad=True)
    opt = torch.optim.Adam([mu, log_sigma], lr=learning_rate)
    log_norm = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))

    elbo = []
    for eps in draws:
        opt.zero_grad()
        z = mu + torch.exp(log_sigma) * eps
        entropy = torch.sum(log_sigma) + log_norm
        loss = -(torch.mean(logdensity_fn(z)) + entropy)
        loss.backward()
        opt.step()
        elbo.append(-loss.detach())
    return ADVIResult(
        mean=mu.detach(),
        log_sigma=log_sigma.detach(),
        elbo_trace=torch.stack(elbo),
    )
