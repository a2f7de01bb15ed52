"""Sampler-state checkpointing with ``torch.save``.

Counterpart of ``celerite2_tpu/inference/checkpoint.py`` (which uses
orbax).  A state is a tree of tensors, ``torch.Generator``s, NamedTuples,
dicts, tuples, lists and plain numbers.  It is written as host copies:
each tensor on the CPU, each NamedTuple as a dict of its fields and each
generator as its state (``get_state()``), so that the file loads with
``torch.load(weights_only=True)`` and a resumed run draws the same numbers.
Given a ``template`` (the same tree as it lives in the run), a restore
puts each tensor back on the template's device and rebuilds the
generators and NamedTuples.

A save writes a temporary file, flushes it to disk and renames it over
the target, so a run killed mid-save leaves the previous checkpoint whole.

A run whose chains are split over the ranks of a ``torch.distributed``
group saves through :class:`GroupCheckpoint`: each rank its own chains, in
a directory of its own, and the ranks resume together.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["save_state", "restore_state", "CheckpointManager", "GroupCheckpoint"]


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_host(tree: Any) -> Any:
    """The host form of ``tree``: a copy of each tensor on the CPU, a
    generator's state, NamedTuples as dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if _is_namedtuple(tree):
        return {k: to_host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def from_host(host: Any, template: Any) -> Any:
    """``host`` (from :func:`to_host`) in the shape of ``template``: each
    tensor copied to the template's device, each generator rebuilt on its
    device from the saved state.  Where the template is None, the host
    value is returned as it is."""
    if template is None:
        return host
    if isinstance(template, torch.Tensor):
        return host.to(template.device, copy=True)
    if isinstance(template, torch.Generator):
        gen = torch.Generator(template.device)
        gen.set_state(host)
        return gen
    if _is_namedtuple(template):
        return type(template)(
            **{k: from_host(host[k], v) for k, v in template._asdict().items()}
        )
    if isinstance(template, dict):
        return {k: from_host(v, template.get(k)) for k, v in host.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(from_host(h, t) for h, t in zip(host, template))
    return host


def save_state(path: str, state: Any) -> None:
    """Write the host form of ``state`` to ``path``, atomically."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(to_host(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore_state(path: str, template: Optional[Any] = None) -> Any:
    """A state saved by :func:`save_state`; with ``template``, rebuilt on
    the template's devices (see :func:`from_host`)."""
    return from_host(torch.load(path, weights_only=True), template)


class CheckpointManager:
    """Rolling checkpoints for a long sampling run: one file a step in
    ``directory``, the newest ``max_to_keep`` kept."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> list:
        names = (self._NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m[1]) for m in names if m)

    def save(self, step: int, state: Any) -> None:
        save_state(self._path(step), state)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None):
        step = self.latest_step() if step is None else step
        return restore_state(self._path(step), template)

    def close(self):
        """Nothing to release: every save is complete when it returns."""


class GroupCheckpoint:
    """One rank's checkpoints of a run whose chains are split over the ranks
    of ``group``, given the run's ``manager`` (the same on every rank).

    Each rank saves in ``<manager.directory>/rank_<i>`` (its index in the
    group), its state tagged with the chains it runs, ``chains = (first,
    stop, fleet)``.  The ranks resume together, from the latest step that
    every rank saved (a rank killed mid-run may lag the others by one), or
    from the start where no rank saved any; a restored state whose tag is not this rank's chains raises (a run
    resumed under another layout)."""

    def __init__(self, manager: CheckpointManager, group, chains):
        rank = dist.get_rank(group)
        self.inner = CheckpointManager(os.path.join(manager.directory, f"rank_{rank}"),
                                       max_to_keep=manager.max_to_keep)
        self.group = group
        self.chains = torch.tensor(chains, dtype=torch.int64)

    def save(self, step: int, state: Any) -> None:
        self.inner.save(step, dict(state, chains=self.chains))

    def latest_step(self) -> Optional[int]:
        """The latest step that every rank of the group saved (a collective)."""
        mine = self.inner.latest_step()
        every = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(every, mine, group=self.group)
        if all(s is None for s in every):
            return None
        if any(s is None for s in every):
            raise ValueError(
                f"checkpoint: ranks {[i for i, s in enumerate(every) if s is None]} "
                f"of the group hold no step under {self.inner.directory}'s parent, "
                "the others do; restart the run in an empty directory"
            )
        step = min(every)
        if step not in self.inner.all_steps():
            raise ValueError(
                f"checkpoint: {self.inner.directory} no longer holds step {step}, "
                "the latest that every rank saved; restart the run"
            )
        return step

    def restore(self, step: Optional[int] = None, template: Any = None):
        state = self.inner.restore(step, template)
        saved = state.get("chains")
        if saved is None or not torch.equal(saved, self.chains):
            raise ValueError(
                f"checkpoint: {self.inner.directory} holds chains "
                f"{None if saved is None else tuple(saved.tolist())} (first, stop, "
                f"fleet), this rank runs {tuple(self.chains.tolist())}; resume "
                "under the layout that saved it"
            )
        return state

    def close(self):
        self.inner.close()
