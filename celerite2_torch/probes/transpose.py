"""Which way of moving E natural-layout planes into the fused slab's
``(T, LP, E, s, 128)`` layout is fastest on the card, and what does it cost
beside a plain copy?

Counterpart of ``benchmarks/probe_transpose_tpu.py`` (``main``, :72-206).
Every arm takes the same E = 12 planes of N float32 rows (numpy's
``default_rng(0)`` normals), packs them as the slab does and reduces to a
scalar; ``chain`` evaluations run back to back, each feeding ``carry + 1e-12
* value`` to the next, as the probe's scan does.  On the card a call of
``chain`` evaluations is captured in a CUDA graph and timed as its replay,
as the probe's scan is one jit:

  noop (2-plane sum)      the sum of two planes: the floor of a call
  sum pre-stacked         the sum of a stacked (E, N)
  stack only, stack+rowpad, copy (stack+pad only)
                          the pack's steps, with no transpose
  torch-T (batched 5d)    one ``permute(1, 4, 0, 2, 3).contiguous()`` of the
                          (E, T, s, 128, LP) planes (the probe's xla-T)
  torch-T2d (batched 2d)  ``(E, TOT, LP) -> (E, LP, TOT)`` by
                          ``transpose(1, 2).contiguous()`` (xla-T2d)
  cuda-T                  the same by the layout kernel K15 (pallas-T)
  cuda round trip         K15, then its inverse K16 (pallas round trip)

Usage (on the card; the plain versions run with ``device="cpu"``)::

    python -m celerite2_torch.probes.transpose [N] [CHAIN]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from celerite2_torch.ops import _build
from celerite2_torch.ops.layout import LANES, slab_inverse, slab_transpose
from celerite2_torch.utils.misc import resolve_device

__all__ = ["E", "SlabGeometry", "pack_natural", "chained", "main"]

E = 12
SUBS = 8
LAYOUT_KERNELS = ("slab_transpose", "slab_inverse")


class SlabGeometry:
    """The slab's geometry for N rows (the probe's :80-86, the fused slab's
    ``Geom`` with the step axis padded to a multiple of 128): blocks of L
    rows, NB = GB blocks, T tiles of s sublanes of 128 lanes (TOT rows of
    blocks), LP steps.  T is 1 for every N: L = max(8, ceil(N / 1024))
    keeps NB <= 1024 = one tile."""

    def __init__(self, N):
        self.N = N = int(N)
        self.L = max(8, min(N, -(-N // (SUBS * LANES))))
        self.NB = -(-N // self.L)
        self.GB = self.NB
        self.T = -(-self.GB // (SUBS * LANES))
        self.s = SUBS if self.T > 1 else -(-self.GB // LANES)
        self.TOT = self.T * self.s * LANES
        self.LP = -(-self.L // LANES) * LANES


def pack_natural(planes, g):
    """The (N,) ``planes`` stacked, zero-padded to GB blocks of L rows, to
    TOT blocks and to LP steps: ``(E, TOT, LP)`` (the probe's :95-110)."""
    x = torch.stack(list(planes))
    n = x.shape[0]
    x = torch.cat([x, x.new_zeros(n, g.NB * g.L - g.N)], -1).reshape(n, g.GB, g.L)
    if g.TOT > g.GB:
        x = torch.cat([x, x.new_zeros(n, g.TOT - g.GB, g.L)], 1)
    if g.LP > g.L:
        x = torch.cat([x, x.new_zeros(n, g.TOT, g.LP - g.L)], 2)
    return x


def chained(step, chain):
    """``chain`` evaluations of ``step(carry, *rest)``, each feeding ``carry
    + 1e-12 * value`` to the next (the probe's scan, :163-172); returns the
    last value."""
    def many(carry, *rest):
        for _ in range(chain):
            v = step(carry, *rest)
            carry = carry + 1e-12 * v
        return v
    return many


def arms(g):
    """``(label, step, stacked)`` of each arm; a ``stacked`` arm's carry is
    the stacked ``(E, N)`` planes, the others' the first plane."""
    def rowpad(flat):
        x = torch.stack(flat)
        x = torch.cat([x, x.new_zeros(E, g.NB * g.L - g.N)], -1)
        return x.reshape(E, g.GB, g.L)

    return (
        ("noop (2-plane sum)", lambda *f: f[0].sum() + f[1].sum(), False),
        ("sum pre-stacked", lambda xs, *f: xs.sum(), True),
        ("stack only", lambda *f: torch.stack(f).sum(), False),
        ("stack+rowpad", lambda *f: rowpad(f).sum(), False),
        ("copy (stack+pad only)", lambda *f: pack_natural(f, g).sum(), False),
        ("torch-T (batched 5d)", lambda *f: pack_natural(f, g).reshape(
            E, g.T, g.s, LANES, g.LP).permute(1, 4, 0, 2, 3).contiguous().sum(), False),
        ("torch-T2d (batched 2d)",
         lambda *f: pack_natural(f, g).transpose(1, 2).contiguous().sum(), False),
        ("cuda-T", lambda *f: slab_transpose(pack_natural(f, g), g.s).sum(), False),
        ("cuda round trip",
         lambda *f: slab_inverse(slab_transpose(pack_natural(f, g), g.s)).sum(), False),
    )


def _replayer(fn, args, dev):
    """``fn(*args)`` as the card will repeat it: on the card, one call
    captured in a CUDA graph, whose replay runs its launches back to back
    as the probe's scan runs inside one jit, so that the host's launch
    rate stays out of the reading; on the CPU the call itself."""
    if dev.type != "cuda":
        return lambda: fn(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    return graph.replay


def _seconds(call, dev):
    """One ``call()``: CUDA events around it on the card, between
    synchronisations; the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3
    began = time.perf_counter()
    call()
    return time.perf_counter() - began


def _time(fn, args, chain, label, dev):
    """The probe's ``_time`` (:39-54): a first call, reported as "compile"
    (it builds the kernels if they are not built), then the best of 3
    calls of ``chain`` evaluations (on the card, replays of a CUDA graph of
    one call).  Returns the arm's ms an evaluation, the first call's value
    and seconds and each layout kernel's launches an evaluation in the
    first call (a graph's replay relaunches its kernels without calling
    the wrappers, which count the launches)."""
    before = {k: _build.LAUNCHES[k] for k in LAYOUT_KERNELS}
    began = time.perf_counter()
    v = float(fn(*args))
    first = time.perf_counter() - began
    launches = {k: (_build.LAUNCHES[k] - before[k]) / chain for k in LAYOUT_KERNELS}
    call = _replayer(fn, args, dev)
    best = min(_seconds(call, dev) for _ in range(3))
    ms = best / chain * 1e3
    clock = "CUDA graph, CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"{label}: {ms:.3f} ms/eval  (compile {first:.0f}s, val={v:.4f}; {clock})",
          flush=True)
    return {"ms": ms, "val": v, "compile_s": first, "launches": launches}


def main(N=100_000, chain=400, device=None):
    """Run every arm at N rows, ``chain`` evaluations a call, on ``device``
    (default the package's, the card).

    Returns ``{"geometry": SlabGeometry, "device": str, "arms": {label:
    {"ms", "val", "compile_s", "launches"}}, "layouts": {...}}``: the arms'
    readings, and the layouts of the planes (their first evaluation's
    inputs): ``"natural"`` ``(E, TOT, LP)``, ``"torch-T2d (batched 2d)"``,
    ``"cuda-T"`` ``(E, LP, s, 128)`` and ``"cuda round trip"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probes.transpose: no CUDA device; pass device='cpu' "
                           "for the plain versions")
    g = SlabGeometry(N)
    print(f"N={g.N} L={g.L} NB={g.NB} TOT={g.TOT} LP={g.LP}", flush=True)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    rng = np.random.default_rng(0)
    flat = tuple(torch.as_tensor(rng.normal(size=g.N), dtype=torch.float32).to(dev)
                 for _ in range(E))
    xs0 = torch.stack(flat)
    readings = {}
    for label, step, stacked in arms(g):
        args = ((xs0,) if stacked else ()) + flat
        readings[label] = _time(chained(step, chain), args, chain, label, dev)
    x = pack_natural(flat, g)
    y = slab_transpose(x, g.s)
    layouts = {
        "natural": x,
        "torch-T2d (batched 2d)": x.transpose(1, 2).contiguous().view(y.shape),
        "cuda-T": y,
        "cuda round trip": slab_inverse(y),
    }
    return {"geometry": g, "device": str(dev), "arms": readings, "layouts": layouts}


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(float(a[0])) if a else 100_000, int(a[1]) if len(a) > 1 else 400)
