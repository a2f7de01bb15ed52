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
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

__all__ = ["save_state", "restore_state", "CheckpointManager"]


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
