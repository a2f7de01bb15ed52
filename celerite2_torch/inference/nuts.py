"""The No-U-Turn sampler over a fleet of chains.

Counterpart of ``celerite2_tpu/inference/nuts.py``.  There, ``nuts_kernel``
is one chain's transition and ``jax.vmap`` turns each subtree's
``lax.while_loop`` into "run while any chain's condition holds, freeze the
others".  Here the transition is written for the fleet directly:

* every tensor of the tree and of a subtree's carry has a leading chain
  axis ``C``, and a chain that has stopped (U-turn, divergence, a full
  subtree) keeps its state through ``torch.where`` masks;
* each leapfrog step evaluates the batched log-density (``(C, dim) ->
  (C,)``) once on the whole fleet, value and gradient together, so a
  transition costs the sum over doublings of the largest number of leaves
  any still-building chain takes in that doubling: what the vmapped loops
  run.  A chain that has stopped is evaluated at its candidate, a finite
  state it keeps, and the result is discarded;
* the leaf index of a subtree is the host's loop counter (every chain
  that is still building has taken the same number of leaves), so the
  checkpoint slots ``ctz(i)`` and the balanced subtrees that close at a
  leaf are exact integers on the host, and a leaf's U-turn checks are one
  gather over the closing subtrees' slots;
* the loop reads the device once per doubling ("is any chain still
  going?") and once per further leaf ("is any chain still building?").

**Random draws are tensors.**  Where the JAX package splits a key, a
transition takes ``NUTSDraws``: standard normals for the momentum, the
directions of the doublings, the uniforms of the leaves (index ``2^d - 1 +
i`` for leaf ``i`` of doubling ``d``) and of the doublings.

Design (from the JAX package): iterative tree doubling with O(max_depth)
memory U-turn checks, multinomial leaf sampling within subtrees and biased
progressive sampling across doublings.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from celerite2_torch.inference.adapt import (
    mass_kinetic,
    mass_matvec,
    mass_momentum,
)
from celerite2_torch.inference.hmc import _potential_and_grad

__all__ = ["NUTSInfo", "NUTSDraws", "draw_nuts", "nuts_kernel", "build_nuts_step"]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) mean leaf acceptance statistic
    num_steps: torch.Tensor  # (C,) leapfrog steps taken
    diverging: torch.Tensor  # (C,) bool
    energy: torch.Tensor  # (C,) -logp at the accepted state
    turning: torch.Tensor  # (C,) bool: trajectory ended by U-turn


class NUTSDraws(NamedTuple):
    z: torch.Tensor  # (C, dim) standard normals of the momentum
    directions: torch.Tensor  # (C, D) +1 or -1 per doubling
    u_leaf: torch.Tensor  # (C, 2^D - 1) leaf i of doubling d at 2^d - 1 + i
    u_tree: torch.Tensor  # (C, D) uniforms of the doublings


def draw_nuts(generator: torch.Generator, C, dim, max_depth, dtype=torch.float64):
    """One transition's draws from ``generator``, on its device."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    z = torch.randn((C, dim), **kw)
    directions = 2.0 * (torch.rand((C, max_depth), **kw) < 0.5).to(dtype) - 1.0
    u_leaf = torch.rand((C, 2**max_depth - 1), **kw)
    u_tree = torch.rand((C, max_depth), **kw)
    return NUTSDraws(z, directions, u_leaf, u_tree)


def _ctz(x: int) -> int:
    """Trailing zeros of a positive integer."""
    return (x & -x).bit_length() - 1


def _is_uturn(q_minus, q_plus, p_minus, p_plus, inv_mass):
    """U-turn test per chain; the states may carry a middle axis of
    subtrees ``(C, m, dim)``, against a metric of one chain axis."""
    if q_minus.dim() == 3:
        inv_mass = inv_mass[:, None]
    dq = q_plus - q_minus
    return ((dq * mass_matvec(inv_mass, p_minus)).sum(-1) < 0) | (
        (dq * mass_matvec(inv_mass, p_plus)).sum(-1) < 0
    )


class _TreeState(NamedTuple):
    # proposal (multinomial over the whole trajectory)
    q_cand: torch.Tensor
    g_cand: torch.Tensor
    logp_cand: torch.Tensor
    logw_tree: torch.Tensor  # logsumexp of leaf weights in the whole tree
    # endpoints of the whole trajectory
    q_left: torch.Tensor
    p_left: torch.Tensor
    g_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    g_right: torch.Tensor
    # statistics
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor


def _where(mask, new, old):
    """``new`` where ``mask (C,)`` holds, else ``old``, over any trailing
    axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _read(flag, counts):
    """``bool(flag.any())``: a read of the device by the host."""
    if counts is not None:
        counts["host_reads"] = counts.get("host_reads", 0) + 1
    return bool(flag.any())


def nuts_kernel(
    logdensity_fn: Callable,
    q: torch.Tensor,
    draws: NUTSDraws,
    step_size,
    inv_mass: torch.Tensor,
    *,
    max_depth: int = 10,
    divergence_threshold: float = 1000.0,
    pot_and_grad=None,
    counts: Optional[dict] = None,
):
    """One NUTS transition of a fleet of chains.

    ``logdensity_fn(q (C, dim)) -> (C,)``; ``q (C, dim)``; ``draws``: a
    :class:`NUTSDraws`; ``step_size``: a number or ``(C,)``; ``inv_mass``:
    ``(C, dim)`` (diagonal) or ``(C, dim, dim)`` (dense).
    ``pot_and_grad``: the potential ``(C,)`` and its gradient ``(C, dim)``
    at ``q`` when the caller has them (the candidate's, from the previous
    transition), else they are evaluated.  ``counts``: a dict that, if
    given, gains ``evaluations`` (of the log-density, on the fleet),
    ``doublings`` and ``host_reads``.

    Returns ``(q_new, logp_new, info, g_new)``: the JAX package's triple
    with ``info`` per chain, and the potential's gradient at ``q_new``.
    """
    C, dim = q.shape
    D = max_depth
    dtype, device = q.dtype, q.device
    step_size = torch.as_tensor(step_size, dtype=dtype, device=device).expand(C)

    def evaluate(x):
        if counts is not None:
            counts["evaluations"] = counts.get("evaluations", 0) + 1
        return _potential_and_grad(logdensity_fn, x)

    pot0, g0 = evaluate(q) if pot_and_grad is None else pot_and_grad
    p0 = mass_momentum(draws.z, inv_mass)
    h0 = pot0 + mass_kinetic(inv_mass, p0)
    false = torch.zeros((C,), dtype=torch.bool, device=device)

    tree = _TreeState(
        q_cand=q,
        g_cand=g0,
        logp_cand=-pot0,
        logw_tree=torch.zeros((C,), dtype=dtype, device=device),
        q_left=q,
        p_left=p0,
        g_left=g0,
        q_right=q,
        p_right=p0,
        g_right=g0,
        sum_accept=torch.zeros((C,), dtype=dtype, device=device),
        n_leaves=torch.zeros((C,), dtype=torch.int32, device=device),
        diverging=false,
        turning=false,
    )

    for depth in range(D):
        keep_going = ~tree.turning & ~tree.diverging
        if not _read(keep_going, counts):
            break
        if counts is not None:
            counts["doublings"] = counts.get("doublings", 0) + 1
        new_tree = _build_subtree(tree, depth, draws, step_size, inv_mass, h0,
                                  evaluate, D, divergence_threshold, counts)
        tree = _TreeState(*(_where(keep_going, n, o) for n, o in zip(new_tree, tree)))

    accept_stat = tree.sum_accept / torch.clamp(tree.n_leaves, min=1)
    info = NUTSInfo(
        accept_prob=accept_stat,
        num_steps=tree.n_leaves,
        diverging=tree.diverging,
        energy=-tree.logp_cand,
        turning=tree.turning,
    )
    return tree.q_cand, tree.logp_cand, info, tree.g_cand


def _build_subtree(tree: _TreeState, depth, draws, step_size, inv_mass, h0,
                   evaluate, D, divergence_threshold, counts) -> _TreeState:
    """Extend every chain's trajectory by up to 2^depth leaves in its own
    direction; chains that stop (U-turn inside the subtree, divergence)
    keep their carry from then on."""
    C, dim = tree.q_cand.shape
    direction = draws.directions[:, depth].to(tree.q_cand.dtype)
    fwd = direction > 0
    e = (step_size * direction)[:, None]

    q = torch.where(fwd[:, None], tree.q_right, tree.q_left)
    p = torch.where(fwd[:, None], tree.p_right, tree.p_left)
    g = torch.where(fwd[:, None], tree.g_right, tree.g_left)
    # checkpoints of the even leaves: leaf i in slot ctz(i), leaf 0 in D
    q_ck = q.new_zeros((C, D + 1, dim))
    p_ck = q.new_zeros((C, D + 1, dim))
    logw_sub = torch.full_like(tree.logw_tree, -torch.inf)
    q_prop, g_prop, logp_prop = tree.q_cand, tree.g_cand, tree.logp_cand
    sum_acc = torch.zeros_like(tree.sum_accept)
    # entering already terminated: such a chain takes no leaf
    stop = tree.turning | tree.diverging
    diverged = torch.zeros_like(stop)
    n_sub = torch.zeros_like(tree.n_leaves)

    for i in range(2**depth):
        building = ~stop
        # leaf 0's read is the doubling's own
        if i > 0 and not _read(building, counts):
            break
        # leapfrog; a chain that has stopped is evaluated at its candidate
        p1 = p - 0.5 * e * g
        q1 = q + e * mass_matvec(inv_mass, p1)
        q1 = torch.where(building[:, None], q1, q_prop)
        pot1, g1 = evaluate(q1)
        p1 = p1 - 0.5 * e * g1
        h1 = pot1 + mass_kinetic(inv_mass, p1)
        delta = h1 - h0
        diverged_i = ~torch.isfinite(h1) | (delta > divergence_threshold)
        logw = torch.where(diverged_i, torch.full_like(delta, -torch.inf), -delta)
        accept = torch.clamp(torch.exp(-delta), max=1.0)
        accept = torch.where(torch.isfinite(accept), accept, torch.zeros_like(accept))

        # progressive multinomial sampling within the subtree
        new_logw_sub = torch.logaddexp(logw_sub, logw)
        u = draws.u_leaf[:, 2**depth - 1 + i]
        take = building & (torch.log(u) < logw - new_logw_sub)
        q_prop = torch.where(take[:, None], q1, q_prop)
        g_prop = torch.where(take[:, None], g1, g_prop)
        logp_prop = torch.where(take, -pot1, logp_prop)

        if i % 2 == 0:
            slot = D if i == 0 else _ctz(i)
            q_ck[:, slot] = torch.where(building[:, None], q1, q_ck[:, slot])
            p_ck[:, slot] = torch.where(building[:, None], p1, p_ck[:, slot])

        # the balanced subtrees of 2^k leaves that close at leaf i start at
        # leaf s = i + 1 - 2^k, held in slot ctz(s) (D for s = 0)
        starts = [i + 1 - 2**k for k in range(1, depth + 1) if (i + 1) % 2**k == 0]
        if starts:
            slots = [D if s == 0 else _ctz(s) for s in starts]
            qs, ps = q_ck[:, slots], p_ck[:, slots]
            f = fwd[:, None, None]
            q1s, p1s = q1[:, None].expand_as(qs), p1[:, None].expand_as(ps)
            turning = _is_uturn(
                torch.where(f, qs, q1s), torch.where(f, q1s, qs),
                torch.where(f, ps, p1s), torch.where(f, p1s, ps), inv_mass,
            ).any(-1)
        else:
            turning = torch.zeros_like(stop)

        b = building[:, None]
        q = torch.where(b, q1, q)
        p = torch.where(b, p1, p)
        g = torch.where(b, g1, g)
        logw_sub = torch.where(building, new_logw_sub, logw_sub)
        sum_acc = sum_acc + torch.where(building, accept, torch.zeros_like(accept))
        diverged = diverged | (building & diverged_i)
        stop = stop | diverged_i | turning
        n_sub = n_sub + building.to(n_sub.dtype)

    # update trajectory endpoints
    f = fwd[:, None]
    q_left = torch.where(f, tree.q_left, q)
    p_left = torch.where(f, tree.p_left, p)
    g_left = torch.where(f, tree.g_left, g)
    q_right = torch.where(f, q, tree.q_right)
    p_right = torch.where(f, p, tree.p_right)
    g_right = torch.where(f, g, tree.g_right)

    subtree_ok = ~stop  # full 2^depth leaves, no divergence or U-turn

    # biased progressive sampling across the doubling
    accept_new = torch.log(draws.u_tree[:, depth]) < logw_sub - tree.logw_tree
    use_new = subtree_ok & accept_new
    u = use_new[:, None]
    q_cand = torch.where(u, q_prop, tree.q_cand)
    g_cand = torch.where(u, g_prop, tree.g_cand)
    logp_cand = torch.where(use_new, logp_prop, tree.logp_cand)

    # U-turn across the full doubled trajectory
    full_turn = _is_uturn(q_left, q_right, p_left, p_right, inv_mass)

    return _TreeState(
        q_cand=q_cand,
        g_cand=g_cand,
        logp_cand=logp_cand,
        logw_tree=torch.logaddexp(tree.logw_tree, logw_sub),
        q_left=q_left,
        p_left=p_left,
        g_left=g_left,
        q_right=q_right,
        p_right=p_right,
        g_right=g_right,
        sum_accept=tree.sum_accept + sum_acc,
        n_leaves=tree.n_leaves + n_sub,
        diverging=tree.diverging | diverged,
        turning=tree.turning | stop | full_turn,
    )


def build_nuts_step(logdensity_fn, *, max_depth=10):
    """A ``(q, draws, step_size, inv_mass) -> (q', logp, info, g')``
    transition of the fleet (see :func:`nuts_kernel`)."""

    def step(q, draws, step_size, inv_mass, pot_and_grad=None):
        return nuts_kernel(
            logdensity_fn,
            q,
            draws,
            step_size,
            inv_mass,
            max_depth=max_depth,
            pot_and_grad=pot_and_grad,
        )

    return step
