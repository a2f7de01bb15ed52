"""Adaptive-tempering Sequential Monte Carlo with HMC mutations.

Counterpart of ``celerite2_tpu/inference/smc.py``.  The particle axis is
plain batching: the log-prior and log-likelihood are batched, ``(P, dim)
-> (P,)``.  Resampling is systematic.  The temperature ladder is chosen
adaptively so the effective sample size stays near a target fraction.
The stages run in a Python loop (``lax.while_loop`` in the JAX package);
each stage draws, from the run's ``torch.Generator``, its resampling
uniform, then the momenta, then the accept tests' uniforms.

**Particles over ranks.**  ``run_smc(..., particle_group=group)`` splits the
cloud over the ranks of a ``torch.distributed`` group (the JAX package's
``particle_axis``).  Each rank evaluates the log-likelihood and the
mutations' log-densities and gradients for its slice only.  In each stage
the slices' log-likelihoods are gathered, so every rank chooses the next
temperature and the evidence increment from the whole vector, as one
process would, and the ranks step together; resampling gathers the cloud,
resamples it whole with the shared uniform and keeps this rank's rows
(the JAX package's "all_gather + local take"); the accept rate is a sum
over the group.  Every rank draws the whole cloud's normals and uniforms
and keeps its rows, so the run does not depend on the layout.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from celerite2_torch.inference.hmc import _fleet_sum, _potential_and_grad, _rows_of_rank

__all__ = ["SMCResult", "run_smc"]


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (P, dim) final posterior particles
    log_evidence: torch.Tensor  # () log marginal-likelihood estimate
    n_stages: torch.Tensor  # () tempering stages used
    final_beta: torch.Tensor  # () should be 1.0
    mutation_eps: torch.Tensor  # () adapted mutation step size


def _systematic_resample(u, log_weights, particles):
    """Systematic resampling of ``particles`` with one uniform ``u``."""
    P = log_weights.shape[0]
    w = torch.softmax(log_weights, dim=0)
    cum = torch.cumsum(w, dim=0)
    pos = (u + torch.arange(P, dtype=w.dtype, device=w.device)) / P
    idx = torch.searchsorted(cum, pos, side="left").clamp(0, P - 1)
    return particles[idx]


def _find_next_beta(log_like, beta, *, target_frac=0.5, n_bisect=32):
    """Largest delta-beta whose incremental weights keep relative ESS
    above ``target_frac`` (bisection, branchless)."""
    P = log_like.shape[0]

    def rel_ess(delta):
        lw = delta * log_like
        lw = lw - torch.max(lw)
        w = torch.exp(lw)
        return (torch.sum(w) ** 2) / (P * torch.sum(w**2))

    lo = torch.zeros_like(beta)
    hi = 1.0 - beta
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = rel_ess(mid) >= target_frac
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # if even the full jump keeps ESS high, go straight to beta = 1
    full_ok = rel_ess(1.0 - beta) >= target_frac
    delta = torch.where(full_ok, 1.0 - beta, lo)
    return torch.clamp(beta + delta, max=1.0)


def _gather(x, group):
    """The ranks' ``x`` joined along dim 0, in rank order (gloo takes host
    tensors: the gather goes through the host); ``x`` itself without a
    group."""
    if group is None:
        return x
    y = x.contiguous().cpu() if dist.get_backend(group) == "gloo" else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def _hmc_mutation(particles, logdensity, eps, scales, z, u, n_steps=10):
    """One fixed-length HMC pass over all particles.

    ``z (P, dim)`` are the momenta and ``u (P,)`` the accept tests'
    uniforms.  ``scales (dim,)`` preconditions the momenta with the
    current particle-cloud spread (a free diagonal mass estimate — SMC
    carries the population, so no Welford warmup is needed)."""
    pot0, g = _potential_and_grad(logdensity, particles)
    h0 = pot0 + 0.5 * torch.sum(z**2, dim=-1)
    q, p = particles, z
    for _ in range(n_steps):
        p = p - 0.5 * eps * scales * g
        q = q + eps * scales * p
        pot1, g = _potential_and_grad(logdensity, q)
        p = p - 0.5 * eps * scales * g
    h1 = pot1 + 0.5 * torch.sum(p**2, dim=-1)
    delta = h0 - h1
    delta = torch.where(torch.isfinite(delta), delta, torch.full_like(delta, -math.inf))
    accept = torch.log(u) < delta
    return torch.where(accept[:, None], q, particles), accept


def run_smc(
    log_prior: Callable,
    log_likelihood: Callable,
    sample_prior: Callable,
    generator: torch.Generator,
    *,
    num_particles: int = 1024,
    max_stages: int = 50,
    target_ess_frac: float = 0.5,
    mutation_steps: int = 10,
    mutation_eps: float = 0.1,
    mutation_target_accept: float = 0.65,
    particle_group=None,
) -> SMCResult:
    """Likelihood-tempered SMC: pi_beta ~ prior * likelihood^beta.

    ``sample_prior(generator, num) -> (num, dim)`` provides the initial
    cloud, on the device of ``generator``.  ``mutation_eps`` only seeds
    the mutation step size: each stage preconditions momenta with the
    particle cloud's per-dimension spread and nudges the step size toward
    ``mutation_target_accept`` acceptance (Robbins-Monro on log eps).

    ``particle_group``: a ``torch.distributed`` group over whose ranks the
    ``num_particles`` are split evenly (the JAX package's
    ``particle_axis``); every rank passes a generator seeded alike and gets
    its rows of the final cloud, and ``log_evidence``, ``n_stages``,
    ``final_beta`` and ``mutation_eps`` equal on every rank.
    """
    group = particle_group
    mine = slice(None)
    if group is not None:
        mine = _rows_of_rank(num_particles, group,
                             f"run_smc: {num_particles} particles")
    particles = sample_prior(generator, num_particles)
    dtype, device = particles.dtype, particles.device
    P = particles.shape[0]
    particles = particles[mine]
    beta = torch.zeros((), dtype=dtype, device=device)
    log_Z = torch.zeros((), dtype=dtype, device=device)
    eps = torch.tensor(mutation_eps, dtype=dtype, device=device)
    stage = 0
    # beta comes from the gathered log-likelihoods: equal on every rank
    while stage < max_stages and bool(beta < 1.0):
        ll = _gather(log_likelihood(particles), group)
        beta_new = _find_next_beta(ll, beta, target_frac=target_ess_frac)
        lw = (beta_new - beta) * ll
        # evidence increment: log mean of incremental weights
        log_Z = log_Z + torch.logsumexp(lw, dim=0) - math.log(P)
        u_res = torch.rand((), generator=generator, dtype=dtype, device=device)
        cloud = _systematic_resample(u_res, lw, _gather(particles, group))
        # population-preconditioned momenta: the resampled cloud's
        # per-dimension spread is a free mass-matrix estimate
        scales = cloud.std(dim=0, correction=0) + 1e-12
        particles = cloud[mine]
        z = torch.randn(cloud.shape, generator=generator, dtype=dtype, device=device)
        u = torch.rand((P,), generator=generator, dtype=dtype, device=device)
        particles, acc = _hmc_mutation(
            particles,
            lambda q, b=beta_new: log_prior(q) + b * log_likelihood(q),
            eps,
            scales,
            z[mine],
            u[mine],
            n_steps=mutation_steps,
        )
        # per-stage step-size adaptation towards ~65% acceptance
        # (Robbins-Monro on log eps; clipped so one stage cannot jump
        # more than ~2.3x)
        rate = _fleet_sum(acc.to(dtype), group) / P
        eps = eps * torch.exp(torch.clamp(rate - mutation_target_accept, -0.3, 0.3))
        beta = beta_new
        stage += 1
    return SMCResult(
        particles=particles,
        log_evidence=log_Z,
        n_stages=torch.tensor(stage),
        final_beta=beta,
        mutation_eps=eps,
    )
