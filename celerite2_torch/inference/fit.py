"""MAP / maximum-likelihood fitting of GP hyperparameters.

Counterpart of ``celerite2_tpu/inference/fit.py``: ``torch.optim.LBFGS``
with a strong-Wolfe line search in place of ``optax.lbfgs`` (one L-BFGS
iteration a step, the same history of 10 pairs), ``torch.optim.Adam`` in
place of ``optax.adam``.  The log-density is batched, as everywhere in
this package: it is called on ``x[None]`` and its one value is taken.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from celerite2_torch.utils.misc import as_tensor

__all__ = ["MAPResult", "fit_map"]


class MAPResult(NamedTuple):
    params: torch.Tensor  # optimum (unconstrained space)
    log_prob: torch.Tensor  # value at optimum
    converged: torch.Tensor  # bool: gradient norm below tolerance
    num_steps: torch.Tensor
    trace: torch.Tensor  # per-step objective values


def fit_map(
    logdensity_fn: Callable,
    init_params,
    *,
    num_steps: int = 500,
    method: str = "lbfgs",
    learning_rate: float = 1e-2,
    gtol: float = 1e-8,
) -> MAPResult:
    """Maximize ``logdensity_fn`` starting from ``init_params`` (dim,);
    ``trace`` holds the log-density before each step."""
    x = as_tensor(init_params).detach().clone().requires_grad_(True)
    if method == "lbfgs":
        # each step is one iteration, whose line search may take up to 25
        # evaluations after the step's first; the steps run on to
        # num_steps as optax's do, so no tolerance ends them early
        opt = torch.optim.LBFGS(
            [x], lr=1.0, max_iter=1, max_eval=26, history_size=10,
            tolerance_grad=0.0, tolerance_change=0.0,
            line_search_fn="strong_wolfe",
        )
    elif method == "adam":
        opt = torch.optim.Adam([x], lr=learning_rate)
    else:
        raise ValueError(f"unknown method {method!r}")

    def loss():
        return -logdensity_fn(x[None])[0]

    def closure():
        opt.zero_grad()
        value = loss()
        value.backward()
        return value

    trace = []
    for step in range(num_steps):
        before = x.detach().clone()
        trace.append(opt.step(closure).detach())
        if method == "lbfgs" and step > 0 and torch.equal(x.detach(), before):
            # after its first step, an L-BFGS step whose line search leaves
            # x where it was is a fixed point: every later step repeats it
            trace += trace[-1:] * (num_steps - step - 1)
            break
    trace = torch.stack(trace)
    value = loss()
    (g,) = torch.autograd.grad(value, x)
    return MAPResult(
        params=x.detach(),
        log_prob=-value.detach(),
        converged=torch.linalg.vector_norm(g) < gtol,
        num_steps=torch.tensor(num_steps),
        trace=-trace,
    )
