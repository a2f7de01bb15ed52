"""Small shared utilities.

Counterpart of ``celerite2_tpu/utils/misc.py`` (``LinAlgError`` and
``atleast_1d``).  The JAX package's ``asarr`` exists only to keep
concrete values out of traced TPU programs; PyTorch runs eagerly, so it
has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, *, like=None):
    """A tensor for ``x``: tensors pass through untouched (autograd keeps
    flowing); Python numbers become float64 and numpy arrays keep their
    dtype.  ``like`` moves the result to that tensor's device and dtype."""
    if not isinstance(x, torch.Tensor):
        if isinstance(x, (int, float)):
            x = torch.tensor(float(x), dtype=torch.float64)
        else:
            x = torch.as_tensor(np.asarray(x))
    if like is not None:
        x = x.to(device=like.device, dtype=like.dtype)
    return x


def atleast_1d(x):
    """``as_tensor`` + promote scalars to rank 1."""
    return torch.atleast_1d(as_tensor(x))


class LinAlgError(Exception):
    """Raised when the celerite matrix is not positive definite.

    Same contract as ``celerite2_tpu.utils.LinAlgError``: eager
    factorization APIs raise it; the log-likelihood uses the quiet
    semantics (``-inf``) instead.
    """
