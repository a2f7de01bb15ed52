"""The NUTS chain runner: a fleet of chains with per-chain windowed
adaptation.

Counterpart of ``celerite2_tpu/inference/sampler.py``.  Each transition is
:func:`celerite2_torch.inference.nuts.nuts_kernel` on the whole fleet.
Unlike ``run_hmc``, the adaptation is per chain: dual averaging on each
chain's acceptance, a Welford diagonal or dense metric per chain, and each
chain's step size frozen at the end of warmup.  The schedule's flags
(warmup, slow window, window end, freeze) live on the host, so the
adaptation branches on them in Python.

The draws of a transition (:class:`~celerite2_torch.inference.nuts.NUTSDraws`)
come from the ``torch.Generator`` that the carry holds, one transition at
a time: at ``max_depth`` 10 a chain's leaf uniforms are 1023 numbers, so a
chunk's worth for a large fleet would not fit.  Chunks, checkpoints and
the monitor go through :func:`celerite2_torch.inference.chunked.drive_chunks`;
the carry holds the generator, so a resume after any chunk is bitwise.

**Chains over ranks.**  ``run_nuts(..., chain_group=group)`` splits the
fleet over the ranks of a ``torch.distributed`` group (the JAX package's
``chain_axis``), with ``run_hmc``'s contract: every rank draws the whole
fleet's tensors (the initial step size's normals, each transition's
:class:`~celerite2_torch.inference.nuts.NUTSDraws`) and keeps its chains'
rows, runs its slice and returns its chains' results.  The adaptation is
per chain, so no statistic crosses the ranks: each rank's tree doubling
stops when its own chains are done, with no collective inside a
transition.  Checkpoints go through ``checkpoint.GroupCheckpoint``, and a
chunk that raises is not retried.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from celerite2_torch.inference import adapt as _adapt
from celerite2_torch.inference.checkpoint import GroupCheckpoint
from celerite2_torch.inference.chunked import drive_chunks
from celerite2_torch.inference.hmc import _potential_and_grad, _rows_of_rank
from celerite2_torch.inference.nuts import NUTSDraws, draw_nuts, nuts_kernel
from celerite2_torch.utils.misc import as_tensor

__all__ = ["NUTSResult", "run_nuts", "warmup_and_sample"]


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, dim)
    log_prob: torch.Tensor  # (C, num_samples)
    accept_prob: torch.Tensor  # (C, num_samples)
    num_steps: torch.Tensor  # (C, num_samples)
    diverging: torch.Tensor  # (C, num_samples) bool
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor  # (C, dim) diagonal metric or (C, dim, dim) dense


def _find_reasonable_step_size(logdensity_fn, q, z, inv_mass):
    """Per chain, double or halve eps from 1 until the one-step acceptance
    crosses 0.5 (at most 60 times; the standard NUTS initialisation).
    ``q (C, dim)``; ``z (C, dim)``: the momentum's standard normals.  The
    chains still moving are evaluated together, one evaluation per trip,
    and the host reads the device once per trip."""
    p = _adapt.mass_momentum(z, inv_mass)
    pot, g = _potential_and_grad(logdensity_fn, q)
    h0 = pot + _adapt.mass_kinetic(inv_mass, p)

    def accept_at(eps):
        e = eps[:, None]
        p1 = p - 0.5 * e * g
        q1 = q + e * _adapt.mass_matvec(inv_mass, p1)
        pot1, g1 = _potential_and_grad(logdensity_fn, q1)
        p1 = p1 - 0.5 * e * g1
        h1 = pot1 + _adapt.mass_kinetic(inv_mass, p1)
        return torch.where(torch.isfinite(h1), torch.exp(h0 - h1), torch.zeros_like(h1))

    eps = torch.ones(q.shape[:1], dtype=q.dtype, device=q.device)
    a = accept_at(eps)
    up = a > 0.5
    factor = torch.where(up, 2.0, 0.5).to(q.dtype)
    moving = torch.ones_like(up)
    for i in range(61):
        moving = moving & torch.where(up, a > 0.5, a < 0.5) & (i < 60)
        if not bool(moving.any()):
            break
        eps = torch.where(moving, eps * factor, eps)
        a = accept_at(eps)
    return eps


class _NUTSCarry(NamedTuple):
    q: torch.Tensor  # (C, dim)
    logp: torch.Tensor  # (C,)
    g: torch.Tensor  # (C, dim) gradient of the potential at q
    da: _adapt.DualAveragingState  # per chain
    wf: _adapt.WelfordState  # per chain
    inv_mass: torch.Tensor  # (C, dim) or (C, dim, dim)
    eps_frozen: torch.Tensor  # (C,)
    rng: torch.Generator  # the run's draws, on the chains' device


def _nuts_segment(
    logdensity_fn: Callable,
    carry: _NUTSCarry,
    sched,
    draws: Iterable[NUTSDraws],
    *,
    max_depth: int,
    target_accept: float,
    counts: Optional[dict] = None,
):
    """One segment of transitions.

    ``sched = (is_warm, in_slow, win_end, freeze)``: host arrays of length
    S.  ``draws``: S transitions' draws, taken one at a time.  Returns the
    carry after the segment and ``(q, logp, accept_prob, num_steps,
    diverging)`` stacked over its transitions.
    """
    C, dim = carry.q.shape
    dense = carry.inv_mass.dim() == 3
    rows = []
    for warm, slow, at_end, freeze, d in zip(*sched, draws):
        da, wf, inv_mass = carry.da, carry.wf, carry.inv_mass
        eps = torch.exp(da.log_eps) if warm else carry.eps_frozen
        q, logp, info, g = nuts_kernel(
            logdensity_fn, carry.q, d, eps, inv_mass, max_depth=max_depth,
            pot_and_grad=(-carry.logp, carry.g), counts=counts,
        )
        if warm:
            da = _adapt.da_update(da, info.accept_prob, target=target_accept)
        if slow:
            wf = _adapt.welford_update(wf, q)
        # at the end of a slow window: set the metric, reset Welford and
        # restart dual averaging around the current step size
        if at_end:
            inv_mass = _adapt.welford_variance(wf)
            wf = _adapt.welford_init(dim, q.dtype, dense=dense, device=q.device,
                                     chains=C)
            da = _adapt.da_init(torch.exp(da.log_eps))
        eps_frozen = carry.eps_frozen
        if freeze:
            eps_frozen = torch.exp(torch.where(da.count > 0, da.log_eps_avg, da.log_eps))
        rows.append((q, logp, info.accept_prob, info.num_steps, info.diverging))
        carry = _NUTSCarry(q=q, logp=logp, g=g, da=da, wf=wf, inv_mass=inv_mass,
                           eps_frozen=eps_frozen, rng=carry.rng)
    outs = tuple(torch.stack(x) for x in zip(*rows))
    return carry, outs


def _schedule(num_warmup, num_samples, thin):
    """(is_warm, in_slow, win_end, freeze) per transition, on the host."""
    total = num_warmup + num_samples * thin
    in_slow, win_end = _adapt.build_schedule(num_warmup)
    pad = np.zeros(num_samples * thin, dtype=bool)
    freeze = np.zeros(total, dtype=bool)
    if num_warmup > 0:
        freeze[num_warmup - 1] = True
    return (
        np.concatenate([np.ones(num_warmup, bool), pad]),
        np.concatenate([in_slow.astype(bool), pad]),
        np.concatenate([win_end.astype(bool), pad]),
        freeze,
    )


def _init_carry(logdensity_fn, q0, z_eps, generator, *, dense_mass):
    """The carry at the start of warmup: each chain's step size from
    :func:`_find_reasonable_step_size` on the momentum ``z_eps``."""
    C, dim = q0.shape
    dtype, device = q0.dtype, q0.device
    if dense_mass:
        inv_mass = torch.eye(dim, dtype=dtype, device=device).expand(C, dim, dim)
    else:
        inv_mass = torch.ones((C, dim), dtype=dtype, device=device)
    inv_mass = inv_mass.contiguous()
    eps0 = _find_reasonable_step_size(logdensity_fn, q0, z_eps, inv_mass)
    pot, g = _potential_and_grad(logdensity_fn, q0)
    return _NUTSCarry(
        q=q0, logp=-pot, g=g, da=_adapt.da_init(eps0),
        wf=_adapt.welford_init(dim, dtype, dense=dense_mass, device=device, chains=C),
        inv_mass=inv_mass, eps_frozen=eps0, rng=generator,
    )


def _run_chains(
    logdensity_fn: Callable,
    q0: torch.Tensor,
    generator: torch.Generator,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    dense_mass: bool = False,
    on_retry: Optional[Callable] = None,
    chain_group=None,
):
    """All chains, warmup and sampling, in segments of transitions.  With
    ``chain_group``, ``q0`` is the whole fleet and this rank runs its slice
    of it (see :func:`run_nuts`)."""
    C, dim = q0.shape
    dtype = q0.dtype
    mine = slice(None)
    if chain_group is not None:
        if on_retry is not None:
            raise ValueError("run_nuts: a chain group's chunks are not retried")
        mine = _rows_of_rank(C, chain_group, f"run_nuts: {C} chains")
        if checkpoint is not None:
            checkpoint = GroupCheckpoint(checkpoint, chain_group,
                                         (mine.start, mine.stop, C))
    sched = _schedule(num_warmup, num_samples, thin)
    total = len(sched[0])
    z_eps = torch.randn((C, dim), generator=generator, dtype=dtype, device=q0.device)
    carry = _init_carry(logdensity_fn, q0[mine], z_eps[mine], generator,
                        dense_mass=dense_mass)

    def segment(c, s):
        # the fleet's draws, this rank's rows
        draws = (NUTSDraws(*(x[mine] for x in draw_nuts(c.rng, C, dim, max_depth, dtype)))
                 for _ in s[0])
        return _nuts_segment(logdensity_fn, c, s, draws, max_depth=max_depth,
                             target_accept=target_accept)

    def seg_stats(c, outs):
        _, _, accs_s, steps_s, divs_s = outs
        return dict(
            mean_accept=float(accs_s.mean()),
            divergences=int(divs_s.sum()),
            mean_leapfrogs=float(steps_s.double().mean()),
            step_size=float(torch.exp(c.da.log_eps).mean()),
        )

    carry, outs = drive_chunks(
        segment, carry, sched, chunk_size=chunk_size, checkpoint=checkpoint,
        monitor=monitor, stat_fn=seg_stats,
        max_retries=2 if chain_group is None else 0, on_retry=on_retry,
    )
    qs, logps, accs, steps, divs = (x.to(q0.device) for x in outs)
    # keep every thin-th post-warmup draw, chain-major
    sel = slice(num_warmup + thin - 1, total, thin)
    return NUTSResult(
        samples=qs[sel].transpose(0, 1),
        log_prob=logps[sel].transpose(0, 1),
        accept_prob=accs[sel].transpose(0, 1),
        num_steps=steps[sel].transpose(0, 1),
        diverging=divs[sel].transpose(0, 1),
        step_size=carry.eps_frozen,
        inv_mass=carry.inv_mass,
    )


def warmup_and_sample(
    logdensity_fn: Callable,
    q0,
    generator: torch.Generator,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
):
    """Single-chain warmup and sampling: ``q0 (dim,)``, and each field of
    the result without its chain axis."""
    q0 = as_tensor(q0)
    res = _run_chains(
        logdensity_fn, q0[None], generator, num_warmup=num_warmup,
        num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept, thin=thin,
    )
    return NUTSResult(*(x[0] for x in res))


def run_nuts(
    logdensity_fn: Callable,
    init_params,
    generator: torch.Generator,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: Optional[int] = None,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    dense_mass: bool = False,
    on_retry: Optional[Callable] = None,
    chain_group=None,
) -> NUTSResult:
    """Run NUTS over one chain or a fleet.

    ``logdensity_fn(q (C, dim)) -> (C,)``: the batched log-density (see
    :mod:`celerite2_torch.inference.hmc`).  ``init_params``: (dim,) (with
    ``num_chains``, chains start from jittered copies) or (C, dim); a
    tensor keeps its device, anything else goes to the package default
    (``Config.device``, the card).  ``generator``: a ``torch.Generator``
    on the chains' device, in place of the JAX package's key.

    ``dense_mass=True`` adapts a full (dim, dim) covariance metric per
    chain during the slow windows; the default is the diagonal metric.
    ``chunk_size``, ``checkpoint``, ``monitor`` and ``on_retry``: see
    :func:`celerite2_torch.inference.chunked.drive_chunks`.
    ``chain_group``: a ``torch.distributed`` group over whose ranks the C
    chains are split evenly (the JAX package's ``chain_axis``), as in
    :func:`~celerite2_torch.inference.hmc.run_hmc`: every rank passes the
    whole fleet's ``init_params`` and a generator seeded alike, runs its
    slice of the chains and gets their results (the monitor's statistics
    are its own chains').  ``checkpoint`` is then the run's manager, the
    same on every rank (each rank saves its chains under it, and the ranks
    resume together); a chunk that raises is not retried, and ``on_retry``
    is refused.
    """
    init_params = as_tensor(init_params)
    dtype, device = init_params.dtype, init_params.device
    if init_params.dim() == 1:
        C = num_chains or 1
        jitter = 0.1 * torch.randn(
            (C, init_params.shape[0]), generator=generator, dtype=dtype, device=device
        )
        q0 = init_params[None, :] + jitter
    else:
        q0 = init_params
    return _run_chains(
        logdensity_fn, q0, generator, num_warmup=num_warmup,
        num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept, thin=thin, chunk_size=chunk_size,
        checkpoint=checkpoint, monitor=monitor, dense_mass=dense_mass,
        on_retry=on_retry, chain_group=chain_group,
    )
