"""The collectives of the sharded paths over a ``torch.distributed`` group.

The JAX package's sharded functions run under ``shard_map`` and exchange
their carries with ``lax.ppermute``, ``lax.all_gather`` and ``lax.psum``
over a mesh axis.  Here each rank is a process, the axis is a process
group, and these functions take its place:

* :func:`from_left` / :func:`from_right`: the ppermute of one boundary row
  to the right / to the left (zeros where nothing enters);
  :func:`prev_rows` / :func:`next_rows` the row shift they serve;
* :func:`all_gather`: every rank's tensor, stacked;
* :func:`psum`: the sum over the ranks;
* :func:`varying`: the identity whose gradient is summed over the ranks
  (``lax.pcast(..., to="varying")``): a replicated input that every rank
  uses on its own shard gets the whole gradient.

``group`` None is one shard: no rank to talk to, every function the
identity of one rank (not ``torch.distributed``'s default group).

The payloads are O(ranks J^2) values (O(ranks D^2) in the adjoint),
whatever N.  The ``gloo`` backend takes host tensors: a tensor on a card is
copied to the host and back, explicitly, around each collective.  ``nccl``
takes the card's tensors as they are.  :data:`COLLECTIVES` counts the calls
and the bytes each rank hands to them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "size",
    "index",
    "all_gather",
    "psum",
    "from_left",
    "from_right",
    "prev_rows",
    "next_rows",
    "varying",
]

# collectives since the last reset, and the bytes this rank handed to them
COLLECTIVES = {"calls": 0, "bytes": 0}


def size(group) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's index in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def _staged(x, group):
    """``x`` as the group's backend takes it: on the host for gloo."""
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        return x.detach().to("cpu")
    return x.detach().contiguous()


def all_gather(x, group):
    """Every rank's ``x``, stacked in rank order: ``(ranks, *x.shape)``."""
    if group is None:
        return x[None]
    y = _staged(x, group)
    out = [torch.empty_like(y) for _ in range(size(group))]
    dist.all_gather(out, y, group=group)
    return torch.stack(out).to(x.device)


def psum(x, group):
    """The sum of ``x`` over the ranks (a new tensor)."""
    if group is None:
        return x
    y = _staged(x, group).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def _exchange(rows, group, shift):
    """Each of ``rows`` from the rank ``shift`` places before this one (zeros
    where there is none), in one all_gather of the rows flattened."""
    if group is None:
        return tuple(torch.zeros_like(r) for r in rows)
    flat = torch.cat([r.reshape(-1) for r in rows])
    g = all_gather(flat, group)
    k = index(group) - shift
    got = g[k] if 0 <= k < g.shape[0] else torch.zeros_like(flat)
    out, at = [], 0
    for r in rows:
        out.append(got[at:at + r.numel()].reshape(r.shape))
        at += r.numel()
    return tuple(out)


def from_left(*rows, group):
    """The left neighbour's ``rows`` (each rank sends its own to the right;
    zeros on the group's first rank)."""
    return _exchange(rows, group, 1)


def from_right(*rows, group):
    """The right neighbour's ``rows`` (zeros on the group's last rank)."""
    return _exchange(rows, group, -1)


def prev_rows(x, group, dim=1):
    """``x`` shifted one row later along ``dim``; the first row from the
    left neighbour's last (zeros on the first rank)."""
    (edge,) = from_left(x.select(dim, -1), group=group)
    return torch.cat([edge.unsqueeze(dim), x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def next_rows(x, group, dim=1):
    """``x`` shifted one row earlier along ``dim``; the last row from the
    right neighbour's first (zeros on the last rank)."""
    (edge,) = from_right(x.select(dim, 0), group=group)
    return torch.cat([x.narrow(dim, 1, x.shape[dim] - 1), edge.unsqueeze(dim)], dim)


class _Varying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def varying(x, group):
    """``x`` unchanged, its gradient summed over the group's ranks: pass a
    replicated input through it before each rank computes its shard's share
    of a replicated result from it."""
    if group is None or not x.requires_grad:
        return x
    return _Varying.apply(x, group)
