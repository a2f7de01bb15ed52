"""The process grid of the sharded paths and the runtime that joins it.

Counterpart of ``celerite2_tpu/parallel/mesh.py``.  The framework's two
parallel axes:

* ``chains``: data parallelism over HMC chains (embarrassingly parallel;
  collectives only for the adaptation's cross-chain means);
* ``seq``: sequence parallelism over the length-N recursions (O(J^2)
  boundary carries exchanged between neighbouring ranks).

On ``torch.distributed`` a device mesh is a grid of ranks, one process a
rank: :func:`make_mesh` lays ``chains x seq`` ranks out row by row (rank =
chain index * seq + seq index), so that the ranks of one ``seq`` group are
consecutive and, when ``LOCAL_WORLD_SIZE`` says how many ranks a host runs,
stay on one host (JAX's host-major rule: the seq carries, exchanged every
likelihood, ride the fast local links; the chains axis carries only
adaptation scalars).  It builds one ``torch.distributed`` group per row of
the grid (the ``seq`` groups) and one per column (the ``chains`` groups).

JAX's ``PartitionSpec`` (``P``) has no counterpart: a rank holds its own
slice of each sharded array, which :func:`chain_sharding` and
:func:`seq_sharding` give, and passes its groups to the sharded functions.

Launch with one process a rank, for example on one host with four cards::

    torchrun --nproc-per-node 4 train.py

    # in train.py
    initialize_distributed(backend="nccl")      # reads torchrun's environment
    mesh = make_mesh(chains=2, seq=2)
    device = torch.device("cuda", mesh.local_rank)

The backend is the caller's choice: ``nccl`` where each rank has a card of
its own, ``gloo`` otherwise (several ranks on one card, or the CPU).  Nothing
here picks a backend or a device on its own.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple, Optional

import torch.distributed as dist

__all__ = [
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "chain_sharding",
    "seq_sharding",
]

logger = logging.getLogger("celerite2_torch")

# how long a collective waits for a rank before it fails (a rank that died
# fails the others instead of hanging them)
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize_distributed(backend: str, *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (wraps ``torch.distributed.init_process_group``,
    with ``timeout``).  With no ``init_method``, ``world_size`` and ``rank``
    the environment a launcher such as ``torchrun`` sets is read.  Safe to
    call when already initialized (logged and ignored)."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized; ignoring")
        return
    kwargs = {"timeout": timeout}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, **kwargs)
    logger.info("distributed runtime up: rank %d / %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


class Mesh(NamedTuple):
    """This rank's place in a ``(chains, seq)`` grid of ranks and its two
    groups: the ranks of its row (``seq_group``, which share its chains
    and split the sequence) and of its column (``chain_group``, which
    share its slice of the sequence and split the chains)."""

    chains: int
    seq: int
    chain_index: int  # this rank's row
    seq_index: int  # this rank's column
    seq_group: object  # torch.distributed ProcessGroup
    chain_group: object
    local_rank: int  # this rank's index on its host


def make_mesh(chains: int = 1, seq: int = 1) -> Mesh:
    """The ``(chains, seq)`` grid over the ranks of the default process
    group, which must hold ``chains * seq`` ranks.  Every rank calls it
    (each group is made by all ranks, in one order).  With more than one
    host (``LOCAL_WORLD_SIZE`` below the world size), ``seq`` must divide
    the ranks a host runs, so that sequence carries stay on the host."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if chains * seq != world:
        raise ValueError(f"mesh ({chains} x {seq}) needs {chains * seq} ranks, "
                         f"the process group has {world}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < world and (seq > per_host or per_host % seq):
        raise ValueError(f"seq={seq} must divide the ranks of a host ({per_host}) "
                         "so that sequence carries stay on the host")
    seq_groups = [dist.new_group([i * seq + j for j in range(seq)])
                  for i in range(chains)]
    chain_groups = [dist.new_group([i * seq + j for i in range(chains)])
                    for j in range(seq)]
    i, j = divmod(rank, seq)
    return Mesh(chains=chains, seq=seq, chain_index=i, seq_index=j,
                seq_group=seq_groups[i], chain_group=chain_groups[j],
                local_rank=int(os.environ.get("LOCAL_RANK", rank % per_host)))


def _slice(n, parts, index, what):
    if n % parts:
        raise ValueError(f"{what}: {n} does not divide over {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def chain_sharding(mesh: Optional[Mesh], num_chains: int) -> slice:
    """This rank's chains: its slice of a leading chains axis (all of it
    for ``mesh`` None, one rank)."""
    if mesh is None:
        return slice(0, num_chains)
    return _slice(num_chains, mesh.chains, mesh.chain_index, "chains")


def seq_sharding(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's rows: its slice of a leading time/sequence axis (all of
    it for ``mesh`` None, one rank)."""
    if mesh is None:
        return slice(0, n)
    return _slice(n, mesh.seq, mesh.seq_index, "seq")
