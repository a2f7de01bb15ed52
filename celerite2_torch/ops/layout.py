"""The fused slab's layout: a batch of planes moved between the natural row
layout and the slab's (sublane, lane) layout.

Counterpart of the two layout kernels of ``benchmarks/probe_transpose_tpu.py``:

* :func:`slab_transpose` (K15), ``make_pallas_T`` (``pallas_call`` at
  :119, body ``transpose_kernel`` at :58): ``(E, TOT, LP)`` planes, TOT =
  s * 128 rows of blocks by LP steps, to ``(E, LP, s, 128)``;
* :func:`slab_inverse` (K16), ``make_pallas_inv`` (:144, body
  ``inv_transpose_kernel`` at :65): the reverse.

Both are one batched 2-D transpose of each plane, ``(E, TOT, LP) <-> (E,
LP, TOT)``, with the transposed plane viewed as ``(E, LP, s, TOT // s)``.
On a CUDA tensor they launch the kernels of ``csrc/slab_layout.cu``
(float32, as the probe); on a CPU tensor they run the plain versions,
which walk the TPU kernel's grid of (plane block, 128-step tile) blocks
and swap the axes of each block as its body does.  The port's own kernels
read ``(C, N, J)`` rows and never relayout: these serve the layout probe,
``celerite2_torch.probes.transpose``.
"""

from __future__ import annotations

import torch

from celerite2_torch.ops import _build

__all__ = [
    "LANES",
    "PLANE_BLOCK",
    "slab_transpose",
    "slab_inverse",
    "slab_transpose_plain",
    "slab_inverse_plain",
]

# lanes of a slab row: the TPU kernel's block of steps and width of a
# sublane row
LANES = 128
# planes a block of the TPU kernel's grid (the probe's EB)
PLANE_BLOCK = 4


def _width(TOT, s):
    if s < 1 or TOT % s:
        raise ValueError(f"slab layout: {TOT} rows do not split into s = {s}")
    return TOT // s


def slab_transpose_plain(x, s):
    """Plain version of K15: ``x (E, TOT, LP)`` to ``y (E, LP, s, TOT //
    s)`` with ``y[e, l, i, j] = x[e, i * (TOT // s) + j, l]``.  Block by
    block of the TPU kernel's grid: :data:`PLANE_BLOCK` planes by
    :data:`LANES` steps in, their axes swapped out (the last blocks may be
    ragged)."""
    E, TOT, LP = x.shape
    W = _width(TOT, s)
    y = x.new_empty(E, LP, TOT)
    for e in range(0, E, PLANE_BLOCK):
        for lp in range(0, LP, LANES):
            y[e:e + PLANE_BLOCK, lp:lp + LANES] = x[e:e + PLANE_BLOCK, :, lp:lp + LANES].transpose(1, 2)
    return y.view(E, LP, s, W)


def slab_inverse_plain(y):
    """Plain version of K16: ``y (E, LP, s, W)`` back to ``x (E, s * W,
    LP)``, block by block of the TPU kernel's grid as
    :func:`slab_transpose_plain`."""
    E, LP, s, W = y.shape
    flat = y.reshape(E, LP, s * W)
    x = y.new_empty(E, s * W, LP)
    for e in range(0, E, PLANE_BLOCK):
        for lp in range(0, LP, LANES):
            x[e:e + PLANE_BLOCK, :, lp:lp + LANES] = flat[e:e + PLANE_BLOCK, lp:lp + LANES].transpose(1, 2)
    return x


# The slab has T = TOT / (s * 128) tiles of blocks, and the TPU kernel's
# output BlockSpec ignores the tile index (``lambda e, t, lp: (e, lp, 0,
# 0)``): with T > 1 every tile would write the same block and only the last
# would survive.  The probe's geometry never gives T > 1 (L = max(8,
# ceil(N / 1024)) keeps N / L <= 1024 blocks, one tile), and the card's
# kernel transposes the whole row axis, so the routers take one tile only.
def _one_tile(name, W):
    if W != LANES:
        raise ValueError(
            f"{name}: the slab has one tile of s x {LANES} rows (T = 1), got "
            f"rows of {W}")


def slab_transpose(x, s):
    """K15: the natural ``(E, s * 128, LP)`` planes in the slab's ``(E, LP,
    s, 128)`` layout; the CUDA kernel for a CUDA tensor, the plain version
    on the CPU."""
    _one_tile("slab_transpose", _width(x.shape[1], s))
    if x.device.type == "cpu":
        return slab_transpose_plain(x, s)
    return _build.slab_transpose_cuda(x, s)


def slab_inverse(y):
    """K16: the slab's ``(E, LP, s, 128)`` planes back in the natural
    ``(E, s * 128, LP)`` layout; the CUDA kernel for a CUDA tensor, the
    plain version on the CPU."""
    _one_tile("slab_inverse", y.shape[-1])
    if y.device.type == "cpu":
        return slab_inverse_plain(y)
    return _build.slab_inverse_cuda(y)
