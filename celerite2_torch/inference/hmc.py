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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from celerite2_torch.inference import adapt as _adapt
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


def _welford_batch(state: _adapt.WelfordState, X):
    """Pooled Welford update with a (C, dim) batch (Chan et al. merge)."""
    C = X.shape[0]
    mean_b = X.mean(dim=0)
    m2_b = ((X - mean_b) ** 2).sum(dim=0)
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
):
    """One segment of iterations.

    ``sched = (is_warm, in_slow, win_end, freeze, u)``: host arrays of
    length S, the flags of each iteration and the Halton jitter.
    ``draws = (z, u_acc)``: standard normals ``(S, C, dim)`` and uniforms
    in [0, 1) ``(S, C)``.  Returns the carry after the segment and
    ``(q, logp, accept_prob, n_steps, diverging)`` stacked over its
    iterations.
    """
    z_all, u_all = draws
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
            da = _adapt.da_update(da, accept_prob.mean(), target=target_accept)
            # ChEES gradient for log T (u-scaled chain rule); proposals,
            # not accepted states, drive the criterion.  Divergent
            # proposals may hold inf/nan positions — replace them with
            # the current state (their accept weight is zero, but inf
            # would still poison the cross-chain means: 0 * inf = nan)
            ok1 = torch.isfinite(h1)[:, None]
            q1s = torch.where(ok1, q1, q)
            v1s = torch.where(ok1, inv_mass * p1, torch.zeros_like(p1))
            m0 = q.mean(dim=0)
            m1 = q1s.mean(dim=0)
            r0 = ((q - m0) ** 2).sum(dim=-1)
            r1 = ((q1s - m1) ** 2).sum(dim=-1)
            per_chain = (r1 - r0) * ((q1s - m1) * v1s).sum(dim=-1)
            wsum = accept_prob.sum() + 1e-6
            chees_grad = float(u) * torch.sum(accept_prob * per_chain) / wsum
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
        wf = _welford_batch(carry.wf, q_new) if slow else carry.wf
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
    dim = q0.shape[1]

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
        shape = (len(s[0]),) + tuple(c.q.shape)
        z = torch.randn(shape, generator=c.rng, dtype=dtype, device=device)
        u = torch.rand(shape[:2], generator=c.rng, dtype=dtype, device=device)
        return _hmc_segment(
            logdensity_fn,
            c,
            s,
            (z, u),
            max_leapfrog=max_leapfrog,
            target_accept=target_accept,
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
