"""The multi-rank training step: HMC over a ``(chains, seq)`` grid of ranks.

Counterpart of ``celerite2_tpu/parallel/train_step.py``.  The parallelism
map:

* dp = ``chains``: each ``chains`` slot of ranks owns a slice of the HMC
  chains (embarrassingly parallel);
* sp = ``seq``: the length-N recursions are split over the ranks of a
  ``seq`` group with O(J^2) carries exchanged (``parallel.sharded``);
* tp, pp, ep: out of scope, the model dimension is J <= 32.

A step is one fixed-length-leapfrog HMC transition of every chain: fixed
iteration counts keep the ``seq`` peers in lockstep.  A rank's chains go
through one batched ``sharded_loglik`` value and gradient per leapfrog step.
The draws come from a ``torch.Generator``: every rank draws the whole
fleet's normals and uniforms and keeps its chains', so a step does not
depend on the layout (the JAX package folds one key a chain instead).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from celerite2_torch.parallel.mesh import Mesh, chain_sharding
from celerite2_torch.parallel.sharded import make_sharded_logdensity
from celerite2_torch.utils.misc import resolve_device

__all__ = ["make_hmc_train_step"]


def make_hmc_train_step(
    kernel_builder: Callable,
    t,
    y,
    yerr,
    mesh: Optional[Mesh] = None,
    *,
    step_size: float = 0.01,
    num_leapfrog: int = 3,
    prior_scale: float = 3.0,
    device=None,
    dtype=torch.float64,
):
    """Build ``(step_fn, init_fn)`` for HMC with the chains split over the
    mesh's ``chains`` axis and the data over its ``seq`` axis (``mesh`` None:
    one rank holds everything).

    ``kernel_builder(theta) -> Term`` maps unconstrained parameters ``(C,
    dim)`` to a kernel with a chain axis; ``t, y, yerr`` are the global
    arrays.  ``init_fn(num_chains, dim, generator)`` gives this rank's
    starting states ``(C / chains, dim)``.  ``step_fn(qs, generator=None, *,
    draws=None) -> (qs', accept)`` on this rank's states: the momenta's
    normals ``(C, dim)`` and the accept tests' uniforms ``(C,)`` of the
    whole fleet, drawn in that order from ``generator`` or given as
    ``draws``, of which the rank keeps its chains'."""
    logd = make_sharded_logdensity(kernel_builder, t, y, yerr, mesh, device=device,
                                   dtype=dtype)
    chains = 1 if mesh is None else mesh.chains

    def logpost(q):
        return logd(q) - 0.5 * ((q / prior_scale) ** 2).sum(-1)

    def val_grad(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = logpost(q)
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    def mine(x, C):
        return x[chain_sharding(mesh, C)]

    def step_fn(qs, generator=None, *, draws=None):
        C = qs.shape[0] * chains
        if draws is None:
            z = torch.randn((C, qs.shape[1]), generator=generator, dtype=qs.dtype,
                            device=generator.device)
            u = torch.rand((C,), generator=generator, dtype=qs.dtype,
                           device=generator.device)
        else:
            z, u = draws
        p0, u = mine(z, C).to(qs.device), mine(u, C).to(qs.device)
        logp0, g = val_grad(qs)
        h0 = -logp0 + 0.5 * (p0**2).sum(-1)
        q, p, logp = qs, p0, logp0
        for _ in range(num_leapfrog):
            p = p + 0.5 * step_size * g
            q = q + step_size * p
            logp, g = val_grad(q)
            p = p + 0.5 * step_size * g
        h1 = -logp + 0.5 * (p**2).sum(-1)
        accept = torch.log(u) < h0 - h1
        return torch.where(accept[:, None], q, qs), accept

    def init_fn(num_chains, dim, generator):
        qs = 0.1 * torch.randn((num_chains, dim), generator=generator, dtype=dtype,
                               device=generator.device)
        return mine(qs, num_chains).to(resolve_device(device))

    return step_fn, init_fn
