"""Observability: roofline counters, a device-aware timer, sampling
monitors.

Counterpart of ``celerite2_tpu/utils/observe.py``.  ``sampling_monitor``
receives per-chunk statistics from the chunked samplers
(``inference.run_hmc(..., monitor=...)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time

import torch

from celerite2_torch.utils.misc import resolve_device

logger = logging.getLogger("celerite2_torch")

__all__ = [
    "logger",
    "Roofline",
    "roofline",
    "Timer",
    "sampling_monitor",
]


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float
    bytes: float
    intensity: float

    def seconds_at(self, *, flops_per_s: float, bytes_per_s: float):
        return max(self.flops / flops_per_s, self.bytes / bytes_per_s)


def roofline(n: int, j: int, nrhs: int = 1, *, dtype_bytes: int = 4,
             backend: str = "scan") -> Roofline:
    """FLOPs / bytes estimate for one fused loglik+grad evaluation.

    scan:  ~10 N J^2 flops fwd + ~20 N J^2 bwd, one read of (t,a,U,V,y)
           plus the S-cache write/read (N J^2).
    assoc: ~2 log2(N) passes over N J^2 elements (factor) and N J nrhs
           (sweeps).
    """
    base_bytes = n * (3 + 2 * j + nrhs) * dtype_bytes
    if backend == "scan":
        flops = 30.0 * n * j * j * max(1, nrhs)
        byts = base_bytes + 2 * n * j * j * dtype_bytes
    else:
        levels = max(1, math.ceil(math.log2(max(n, 2))))
        flops = 8.0 * n * j**3 * levels
        byts = base_bytes + 2 * levels * n * j * j * dtype_bytes
    return Roofline(flops=flops, bytes=byts, intensity=flops / byts)


class Timer:
    """Times the work issued inside its ``with`` block on ``device``
    (default ``Config.device``): between two CUDA events, waiting for the
    second, on the card; by the host's clock on the CPU.  ``elapsed`` is
    in seconds."""

    def __init__(self, label: str = "", *, device=None):
        self.label = label
        self.device = resolve_device(device)
        self.elapsed = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            start, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.elapsed = start.elapsed_time(end) / 1000.0
        else:
            self.elapsed = time.perf_counter() - self._start
        if self.label:
            logger.info("%s: %.4fs", self.label, self.elapsed)
        return False


@contextlib.contextmanager
def sampling_monitor(log_every: int = 100):
    """Collects the summaries a chunked runner emits: yields ``(emit,
    records)``, where ``emit(step, stats)`` appends ``(step, stats)`` with
    each stat a float, and logs every ``log_every``-th record."""
    records = []

    def emit(step, stats):
        records.append((int(step), {k: float(v) for k, v in stats.items()}))
        if log_every and len(records) % log_every == 0:
            logger.info("step %d: %s", step, stats)

    yield emit, records
