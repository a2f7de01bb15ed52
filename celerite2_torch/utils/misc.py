"""Small shared utilities.

Counterpart of ``celerite2_tpu/utils/misc.py`` (``LinAlgError`` and
``atleast_1d``).  The JAX package's ``asarr`` exists only to keep
concrete values out of traced TPU programs; PyTorch runs eagerly, so it
has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from celerite2_torch.config import get_config


def resolve_device(device=None):
    """``device`` if given, else the package default (``Config.device``)."""
    return torch.device(get_config().device if device is None else device)


def as_tensor(x, *, like=None, device=None):
    """A tensor for ``x``.

    A tensor passes through untouched: it keeps its device, and autograd
    keeps flowing.  Anything else (a Python number, which becomes float64;
    a numpy array or a list, which keep their dtype) is placed on
    ``like``'s device if ``like`` is given, else on ``device``, else on
    the package default ``Config.device``.  ``like`` also moves a tensor
    to that tensor's device and dtype.  A number is filled in on the device
    (no copy from the host, which on the card would wait for the stream)."""
    if not isinstance(x, torch.Tensor):
        target = like.device if like is not None else resolve_device(device)
        if isinstance(x, (int, float)):
            x = torch.full((), float(x), dtype=torch.float64, device=target)
        else:
            x = torch.as_tensor(np.asarray(x)).to(target)
    if like is not None:
        x = x.to(device=like.device, dtype=like.dtype)
    return x


def atleast_1d(x, *, device=None):
    """``as_tensor`` + promote scalars to rank 1."""
    return torch.atleast_1d(as_tensor(x, device=device))


def first_device(*values):
    """The device of the first tensor among ``values``, else None: the
    numbers given beside a tensor parameter follow that tensor."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


class LinAlgError(Exception):
    """Raised when the celerite matrix is not positive definite.

    Same contract as ``celerite2_tpu.utils.LinAlgError``: eager
    factorization APIs raise it; the log-likelihood uses the quiet
    semantics (``-inf``) instead.
    """
