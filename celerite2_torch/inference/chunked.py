"""Chunked, checkpointable execution of the samplers.

Counterpart of ``celerite2_tpu/inference/chunked.py``.  A sampler's run is
a schedule of steps; ``drive_chunks`` runs it in segments of ``chunk_size``
steps through one segment function and, between segments,

* appends the segment's outputs on the host,
* feeds summary stats to a ``monitor`` callback
  (:func:`celerite2_torch.utils.observe.sampling_monitor`),
* saves ``{carry, outs}`` to a
  :class:`celerite2_torch.inference.checkpoint.CheckpointManager`, so a
  killed run resumes bit-compatibly from the last completed chunk.

The carry's host copy (:func:`checkpoint.to_host`: tensors on the CPU, a
generator's state) is also the restart point of a chunk whose run raises.
A retry runs the same segment function on the same device from that copy;
it never moves work to another device.  On the card a CUDA fault leaves
the context unusable, so its retries fail again and the error surfaces
after ``max_retries``.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from celerite2_torch.inference.checkpoint import from_host, to_host

__all__ = ["drive_chunks"]


def _slice_sched(sched, lo, hi):
    return tuple(s[lo:hi] for s in sched)


def _concat(a, b):
    """Two segments' outputs joined along the step axis."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b], dim=0)
    return type(a)(_concat(x, y) for x, y in zip(a, b))


def drive_chunks(
    seg_fn: Callable,
    carry: Any,
    sched: Sequence[np.ndarray],
    *,
    chunk_size: Optional[int] = None,
    checkpoint=None,
    monitor: Optional[Callable] = None,
    stat_fn: Optional[Callable] = None,
    max_retries: int = 2,
    on_retry: Optional[Callable] = None,
):
    """Run ``seg_fn(carry, sched_slice) -> (carry, outs)`` over the full
    schedule, optionally in chunks.

    ``sched`` — tuple of per-step host arrays (length = total steps).
    ``chunk_size=None`` runs everything in one segment.
    ``checkpoint`` — a ``CheckpointManager``; chunk ``i``'s state is
    saved under step ``i``, and an existing checkpoint is resumed from
    when it was written under the same ``(chunk_size, total)``.
    ``monitor(step, stats)`` is called after each chunk with
    ``stat_fn(carry, outs) -> dict`` (skipped when either is None).

    ``max_retries``: a chunk whose run (or copy to the host) raises is
    retried from the host copy of the carry after the last completed
    chunk, up to ``max_retries`` times per chunk.  ``on_retry(chunk_index,
    attempt, exception)`` is called before each retry; a warning is
    emitted otherwise.  The retried chunk reruns the same segment on the
    same carry, so the results are those of a run without the fault.

    Returns ``(carry, outs)`` with segment outputs concatenated along
    axis 0 (step-major, as if run in one segment); chunked, the outputs
    are on the host.
    """
    total = len(sched[0])

    if chunk_size is None or chunk_size >= total:
        carry, outs = seg_fn(carry, _slice_sched(sched, 0, total))
        if monitor is not None and stat_fn is not None:
            monitor(total, stat_fn(carry, outs))
        return carry, outs

    bounds = list(range(0, total, chunk_size)) + [total]
    segments = list(zip(bounds[:-1], bounds[1:]))

    outs_acc = None
    start_idx = 0
    sched_meta = torch.tensor([int(chunk_size), int(total)], dtype=torch.int64)
    # the carry as the run holds it: the devices a restore goes back to
    template = carry
    if checkpoint is not None:
        latest = checkpoint.latest_step()
        if latest is not None:
            # a checkpoint written under a different chunk schedule
            # cannot be resumed bit-compatibly
            if latest >= len(segments):
                raise ValueError(
                    f"checkpoint step {latest} does not exist in the "
                    f"current schedule ({len(segments)} chunks of "
                    f"{chunk_size}); the saved run used a different "
                    "chunk_size/total — restart or match the schedule"
                )
            restored = checkpoint.restore(latest, template=dict(carry=template))
            saved_meta = restored.get("sched_meta")
            if saved_meta is None or not torch.equal(saved_meta, sched_meta):
                raise ValueError(
                    f"checkpoint was written with (chunk_size, total) = "
                    f"{None if saved_meta is None else tuple(saved_meta.tolist())}"
                    f", current run uses {tuple(sched_meta.tolist())}; "
                    "resume requires an identical chunk schedule"
                )
            carry = restored["carry"]
            outs_acc = restored["outs"]
            start_idx = latest + 1

    # the restart point of a chunk whose run raises
    carry_host = to_host(carry)

    for i in range(start_idx, len(segments)):
        lo, hi = segments[i]
        attempt = 0
        while True:
            try:
                carry_new, outs = seg_fn(carry, _slice_sched(sched, lo, hi))
                # the copy to the host is where an asynchronous device
                # fault surfaces: keep it inside the retry scope
                outs = to_host(outs)
                carry_host_new = to_host(carry_new)
                break
            except Exception as exc:  # noqa: BLE001 - any fault of the run
                attempt += 1
                if attempt > max_retries:
                    raise
                if on_retry is not None:
                    on_retry(i, attempt, exc)
                else:
                    warnings.warn(
                        f"chunk {i} failed ({type(exc).__name__}: {exc});"
                        f" retrying from the last completed chunk"
                        f" (attempt {attempt}/{max_retries})",
                        stacklevel=2,
                    )
                carry = from_host(carry_host, template)
        carry = carry_new
        carry_host = carry_host_new
        outs_acc = outs if outs_acc is None else _concat(outs_acc, outs)
        if checkpoint is not None:
            checkpoint.save(
                i, dict(carry=carry_host, outs=outs_acc, sched_meta=sched_meta)
            )
        if monitor is not None and stat_fn is not None:
            monitor(hi, stat_fn(carry, outs))

    return carry, outs_acc
