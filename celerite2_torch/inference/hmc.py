"""Fleet-scale adaptive HMC (ChEES-style) — the fixed-trajectory path.

Counterpart of ``celerite2_tpu/inference/hmc.py``.  Every chain runs the
same number of leapfrog steps in an iteration, so the chains are plain
batching:

* one **shared** jittered trajectory length per iteration (Halton
  sequence): the leapfrog loop is one Python loop whose trip count is the
  only value the host reads from the device in an iteration;
* the log-density is evaluated on the whole fleet at once, once per
  leapfrog step;
* cross-chain adaptation — shared dual-averaging step size on the mean
  acceptance, pooled Welford diagonal mass, and ChEES trajectory-length
  adaptation (Hoffman, Radul & Sountsov 2021): maximize
  ``E[(||q' - m'||^2 - ||q - m||^2)^2]`` by Adam on ``log T`` with the
  per-chain gradient estimate
  ``accept_i * (||q'_i - m'||^2 - ||q_i - m||^2) * (q'_i - m') . v'_i``
  (v' = preconditioned endpoint velocity), acceptance-weighted across
  the fleet.

**The log-density is batched.**  The JAX package vmaps a scalar
log-density; here ``logdensity_fn(q)`` takes the fleet's positions ``q
(C, dim)`` and returns ``(C,)``, as ``gp_loglik`` does with parameters of a
leading chain axis.  The gradient is ``torch.autograd.grad(logp.sum(),
q)``, which is each chain's own gradient only because no chain's
log-density depends on another chain's position.  No graph is kept
across leapfrog steps.

**Random draws are tensors.**  ``_hmc_segment`` takes each iteration's
standard normals (the momenta before the mass scaling) and the uniforms
of its accept tests; ``run_hmc`` draws a chunk's worth of both up front
from the ``torch.Generator`` that the carry holds in place of the JAX
package's key.

The schedule's flags (warmup, slow window, window end, freeze) live on
the host, so the adaptation branches on them in Python; conditions on
device values stay ``torch.where``.

**Chains over ranks.**  ``run_hmc(..., chain_group=group)`` splits the fleet
over the ranks of a ``torch.distributed`` group (the counterpart of the JAX
package's ``chain_axis``): each rank runs its slice of the chains, and the
cross-chain means of the adaptation (the dual-averaging acceptance, ChEES's
centres and weighted sums, the pooled Welford moments) are sums over the
group (``all_reduce``; through the host for gloo).  Every rank draws the
whole fleet's normals and uniforms and keeps its chains', so the run does
not depend on the layout beyond the order of those sums.  Each rank
checkpoints its own chains (``checkpoint.GroupCheckpoint``), and a chunk
that raises is not retried: a rank that reran it alone would pair its sums
with the other ranks' later ones.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from celerite2_torch.inference import adapt as _adapt
from celerite2_torch.inference.checkpoint import GroupCheckpoint
from celerite2_torch.inference.chunked import drive_chunks
from celerite2_torch.utils.misc import as_tensor

__all__ = ["HMCResult", "run_hmc"]


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, dim)
    log_prob: torch.Tensor  # (C, num_samples)
    accept_prob: torch.Tensor  # (C, num_samples)
    num_steps: torch.Tensor  # (num_samples,) shared per-iteration counts
    diverging: torch.Tensor  # (C, num_samples) bool
    step_size: torch.Tensor  # () shared
    trajectory_length: torch.Tensor  # () shared
    inv_mass: torch.Tensor  # (dim,) shared


class _AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor


def _adam_init(dtype, device=None):
    z = torch.zeros((), dtype=dtype, device=device)
    return _AdamState(m=z, v=z, count=z)


def _adam_step(state: _AdamState, grad, *, lr=0.025, b1=0.9, b2=0.999):
    count = state.count + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad**2
    mh = m / (1 - b1**count)
    vh = v / (1 - b2**count)
    update = lr * mh / (torch.sqrt(vh) + 1e-8)
    return _AdamState(m=m, v=v, count=count), update


def _halton(n, base=2):
    """Radical-inverse (van der Corput) sequence in (0, 1)."""
    seq = np.zeros(n)
    for i in range(n):
        f, r = 1.0, 0.0
        k = i + 1
        while k > 0:
            f /= base
            r += f * (k % base)
            k //= base
        seq[i] = r
    return seq


def _fleet_sum(x, group):
    """The sum over the fleet's chains (dim 0), over the group's ranks (gloo
    takes host tensors: the sum goes to the host and back)."""
    s = x.sum(dim=0)
    if group is None:
        return s
    y = s.cpu() if dist.get_backend(group) == "gloo" else s
    dist.all_reduce(y, group=group)
    return y.to(s.device)


def _rows_of_rank(n, group, what):
    """This rank's slice of ``n`` rows split evenly over the ranks of
    ``group``; ``what`` names the rows in the error when they do not
    divide."""
    ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % ranks:
        raise ValueError(f"{what} do not divide over {ranks} ranks")
    per = n // ranks
    return slice(rank * per, (rank + 1) * per)


def _fleet_mean(x, group, C):
    """The mean over the fleet's ``C`` chains (dim 0)."""
    return x.mean(dim=0) if group is None else _fleet_sum(x, group) / C


def _welford_batch(state: _adapt.WelfordState, X, group=None, C=None):
    """Pooled Welford update with a (C, dim) batch (Chan et al. merge); with
    ``group`` the batch is the ranks' chains together, ``C`` of them."""
    C = X.shape[0] if group is None else C
    mean_b = _fleet_mean(X, group, C)
    m2_b = _fleet_sum((X - mean_b) ** 2, group)
    count = state.count + C
    delta = mean_b - state.mean
    mean = state.mean + delta * (C / count)
    m2 = state.m2 + m2_b + delta**2 * (state.count * C / count)
    return _adapt.WelfordState(mean=mean, m2=m2, count=count)


class _HMCCarry(NamedTuple):
    q: torch.Tensor  # (C, dim)
    logp: torch.Tensor  # (C,)
    g: torch.Tensor  # (C, dim) grad of potential
    da: _adapt.DualAveragingState  # shared step size
    adam: _AdamState  # shared log-trajectory-length
    log_T: torch.Tensor  # () shared trajectory length
    wf: _adapt.WelfordState  # pooled mass estimate
    inv_mass: torch.Tensor  # (dim,)
    eps_frozen: torch.Tensor  # ()
    rng: torch.Generator  # the run's draws, on the chains' device


def carry_from_numpy(fields, *, generator: torch.Generator,
                     dtype=torch.float64) -> _HMCCarry:
    """The port's carry from a JAX ``_HMCCarry``'s fields as numpy arrays
    (a mapping of field name to array, or to a NamedTuple or mapping of
    arrays for ``da``, ``adam`` and ``wf``; ``key`` is not read), on the
    device of ``generator``, which takes the key's place."""

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=generator.device)

    def state(cls, x):
        if isinstance(x, dict):
            return cls(**{k: t(v) for k, v in x.items()})
        return cls(*map(t, x))

    return _HMCCarry(
        q=t(fields["q"]),
        logp=t(fields["logp"]),
        g=t(fields["g"]),
        da=state(_adapt.DualAveragingState, fields["da"]),
        adam=state(_AdamState, fields["adam"]),
        log_T=t(fields["log_T"]),
        wf=state(_adapt.WelfordState, fields["wf"]),
        inv_mass=t(fields["inv_mass"]),
        eps_frozen=t(fields["eps_frozen"]),
        rng=generator,
    )


def _potential_and_grad(logdensity_fn, q):
    """The potential ``-logdensity_fn(q)`` (C,) and its gradient (C, dim)
    at the fleet's positions, with no graph kept."""
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        logp = logdensity_fn(q)
        (g,) = torch.autograd.grad(logp.sum(), q)
    return -logp.detach(), -g


def _hmc_segment(
    logdensity_fn: Callable,
    carry: _HMCCarry,
    sched,
    draws,
    *,
    max_leapfrog: int,
    target_accept: float,
    divergence_threshold: float = 1000.0,
    chain_group=None,
    num_chains: Optional[int] = None,
):
    """One segment of iterations.

    ``sched = (is_warm, in_slow, win_end, freeze, u)``: host arrays of
    length S, the flags of each iteration and the Halton jitter.
    ``draws = (z, u_acc)``: standard normals ``(S, C, dim)`` and uniforms
    in [0, 1) ``(S, C)`` of this rank's chains.  ``chain_group``: the ranks
    whose chains make up the fleet of ``num_chains``, over which the
    cross-chain means run.  Returns the carry after the segment and
    ``(q, logp, accept_prob, n_steps, diverging)`` stacked over its
    iterations.
    """
    z_all, u_all = draws
    group, C_all = chain_group, num_chains
    dim = carry.q.shape[-1]
    dtype, device = carry.q.dtype, carry.q.device
    rows = []
    for warm, slow, at_end, freeze, u, z, u_acc in zip(*sched, z_all, u_all):
        q, logp, g = carry.q, carry.logp, carry.g
        inv_mass = carry.inv_mass

        eps = torch.exp(carry.da.log_eps) if warm else carry.eps_frozen
        T = torch.exp(carry.log_T)
        # shared jittered step count for this iteration: the one value
        # the host reads from the device in an iteration
        n_steps = int(torch.clamp(torch.ceil(float(u) * T / eps), 1, max_leapfrog))

        p0 = z / torch.sqrt(inv_mass)
        h0 = -logp + 0.5 * torch.sum(inv_mass * p0**2, dim=-1)

        # batched leapfrog; the last step's potential is the endpoint's
        q1, p1, g1 = q, p0, g
        for _ in range(n_steps):
            p1 = p1 - 0.5 * eps * g1
            q1 = q1 + eps * inv_mass * p1
            pot1, g1 = _potential_and_grad(logdensity_fn, q1)
            p1 = p1 - 0.5 * eps * g1
        h1 = pot1 + 0.5 * torch.sum(inv_mass * p1**2, dim=-1)

        delta = h1 - h0
        diverging = ~torch.isfinite(h1) | (delta > divergence_threshold)
        accept_prob = torch.where(
            diverging, torch.zeros_like(delta), torch.clamp(torch.exp(-delta), max=1.0)
        )
        take = u_acc < accept_prob
        q_new = torch.where(take[:, None], q1, q)
        logp_new = torch.where(take, -pot1, logp)
        g_new = torch.where(take[:, None], g1, g)

        # ---- shared adaptation (warmup only)
        da, adam, log_T = carry.da, carry.adam, carry.log_T
        if warm:
            da = _adapt.da_update(da, _fleet_mean(accept_prob, group, C_all),
                                  target=target_accept)
            # ChEES gradient for log T (u-scaled chain rule); proposals,
            # not accepted states, drive the criterion.  Divergent
            # proposals may hold inf/nan positions — replace them with
            # the current state (their accept weight is zero, but inf
            # would still poison the cross-chain means: 0 * inf = nan)
            ok1 = torch.isfinite(h1)[:, None]
            q1s = torch.where(ok1, q1, q)
            v1s = torch.where(ok1, inv_mass * p1, torch.zeros_like(p1))
            m0 = _fleet_mean(q, group, C_all)
            m1 = _fleet_mean(q1s, group, C_all)
            r0 = ((q - m0) ** 2).sum(dim=-1)
            r1 = ((q1s - m1) ** 2).sum(dim=-1)
            per_chain = (r1 - r0) * ((q1s - m1) * v1s).sum(dim=-1)
            wsum = _fleet_sum(accept_prob, group) + 1e-6
            chees_grad = float(u) * _fleet_sum(accept_prob * per_chain, group) / wsum
            # normalize scale so Adam's lr is geometry-free (paper sec. 4)
            chees_grad = chees_grad / (torch.abs(chees_grad) + 1e-6)
            adam, dlogT = _adam_step(adam, chees_grad)
            # keep T within the leapfrog budget, and never let a stray
            # non-finite wipe the state
            log_T_new = torch.clamp(
                log_T + dlogT, torch.log(eps), torch.log(eps * max_leapfrog)
            )
            log_T = torch.where(torch.isfinite(log_T_new), log_T_new, log_T)

        # pooled Welford mass across all chains
        wf = _welford_batch(carry.wf, q_new, group, C_all) if slow else carry.wf
        if at_end:
            inv_mass = _adapt.welford_variance(wf)
            wf = _adapt.welford_init(dim, dtype, device=device)
            da = _adapt.da_init(torch.exp(da.log_eps))
        eps_frozen = carry.eps_frozen
        if freeze:
            eps_frozen = torch.exp(torch.where(da.count > 0, da.log_eps_avg, da.log_eps))

        rows.append((q_new, logp_new, accept_prob, n_steps, diverging))
        carry = _HMCCarry(
            q=q_new,
            logp=logp_new,
            g=g_new,
            da=da,
            adam=adam,
            log_T=log_T,
            wf=wf,
            inv_mass=inv_mass,
            eps_frozen=eps_frozen,
            rng=carry.rng,
        )

    qs, logps, accs, steps, divs = zip(*rows)
    outs = (
        torch.stack(qs),
        torch.stack(logps),
        torch.stack(accs),
        torch.tensor(steps, dtype=torch.int32, device=device),
        torch.stack(divs),
    )
    return carry, outs


def run_hmc(
    logdensity_fn: Callable,
    init_params,
    generator: torch.Generator,
    *,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: Optional[int] = None,
    max_leapfrog: int = 1024,
    target_accept: float = 0.8,
    thin: int = 1,
    initial_step_size: float = 0.1,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor=None,
    on_retry: Optional[Callable] = None,
    chain_group=None,
) -> HMCResult:
    """Adaptive fixed-trajectory HMC over a chain fleet.

    ``logdensity_fn(q (C, dim)) -> (C,)``: the batched log-density (see
    the module's docstring).  ``init_params``: (dim,) (jittered to
    ``num_chains``) or (C, dim); a tensor keeps its device, anything else
    goes to the package default (``Config.device``, the card).
    ``generator``: a ``torch.Generator`` on the chains' device; the run's
    draws come from it, in place of the JAX package's key.
    ``chunk_size``, ``checkpoint``, ``monitor`` and ``on_retry``: see
    :func:`celerite2_torch.inference.chunked.drive_chunks`.
    ``chain_group``: a ``torch.distributed`` group over whose ranks the C
    chains are split evenly (the JAX package's ``chain_axis``); every rank
    passes the whole fleet's ``init_params`` and a generator seeded alike,
    runs its slice of the chains, and gets their results (the monitor's
    statistics are its own chains').  With a group, ``checkpoint`` is the
    run's manager, the same on every rank: each rank saves its chains under
    it (:class:`~celerite2_torch.inference.checkpoint.GroupCheckpoint`) and
    the ranks resume together; a chunk that raises is not retried, and
    ``on_retry`` is refused.
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
    C_all, dim = q0.shape
    mine = slice(None)
    if chain_group is not None:
        if on_retry is not None:
            raise ValueError("run_hmc: a chain group's chunks are not retried")
        mine = _rows_of_rank(C_all, chain_group, f"run_hmc: {C_all} chains")
        q0 = q0[mine]
        if checkpoint is not None:
            checkpoint = GroupCheckpoint(checkpoint, chain_group,
                                         (mine.start, mine.stop, C_all))

    total = num_warmup + num_samples * thin
    in_slow, win_end = _adapt.build_schedule(num_warmup)
    pad = np.zeros(num_samples * thin, dtype=bool)
    sched = (
        np.concatenate([np.ones(num_warmup, bool), pad]),  # is_warm
        np.concatenate([in_slow, pad]),  # in_slow
        np.concatenate([win_end, pad]),  # win_end
        np.eye(1, total, max(num_warmup - 1, 0), dtype=bool)[0],  # freeze
        _halton(total),  # trajectory jitter
    )

    pot0, g0 = _potential_and_grad(logdensity_fn, q0)
    eps0 = torch.tensor(initial_step_size, dtype=dtype, device=device)
    carry = _HMCCarry(
        q=q0,
        logp=-pot0,
        g=g0,
        da=_adapt.da_init(eps0),
        adam=_adam_init(dtype, device),
        log_T=torch.log(eps0),  # ChEES grows T from one step
        wf=_adapt.welford_init(dim, dtype, device=device),
        inv_mass=torch.ones((dim,), dtype=dtype, device=device),
        eps_frozen=eps0,
        rng=generator,
    )

    def segment(c, s):
        # one chunk's draws, up front: the momenta's normals, then the
        # accept tests' uniforms
        shape = (len(s[0]), C_all, dim)
        z = torch.randn(shape, generator=c.rng, dtype=dtype, device=device)
        u = torch.rand(shape[:2], generator=c.rng, dtype=dtype, device=device)
        return _hmc_segment(
            logdensity_fn,
            c,
            s,
            (z[:, mine], u[:, mine]),
            max_leapfrog=max_leapfrog,
            target_accept=target_accept,
            chain_group=chain_group,
            num_chains=C_all,
        )

    def seg_stats(c, outs):
        _, _, accs_s, steps_s, divs_s = outs
        return dict(
            mean_accept=float(accs_s.mean()),
            divergences=int(divs_s.sum()),
            mean_leapfrogs=float(steps_s.double().mean()),
            step_size=float(torch.exp(c.da.log_eps)),
            trajectory_length=float(torch.exp(c.log_T)),
        )

    carry, outs = drive_chunks(
        segment,
        carry,
        sched,
        chunk_size=chunk_size,
        checkpoint=checkpoint,
        monitor=monitor,
        stat_fn=seg_stats,
        max_retries=2 if chain_group is None else 0,
        on_retry=on_retry,
    )
    qs, logps, accs, steps, divs = (x.to(device) for x in outs)

    sel = slice(num_warmup + thin - 1, total, thin)
    return HMCResult(
        samples=qs[sel].transpose(0, 1),
        log_prob=logps[sel].transpose(0, 1),
        accept_prob=accs[sel].transpose(0, 1),
        num_steps=steps[sel],
        diverging=divs[sel].transpose(0, 1),
        step_size=carry.eps_frozen,
        trajectory_length=torch.exp(carry.log_T),
        inv_mass=carry.inv_mass,
    )
