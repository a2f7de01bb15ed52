"""Runtime configuration for celerite2-torch.

Counterpart of ``celerite2_tpu/config.py``.  The width contract, the
dtype policy and the choice of tier (``backend``, ``assoc_threshold``)
carry over; the JAX package's engine, planes, Pallas and fused-slab knobs
steer TPU code paths that this package does not have.  ``device`` is
this package's own: PyTorch places each tensor explicitly, where JAX has
one default backend.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# The reference caps the celerite width at 32 (terms.hpp:10-12).
MAX_WIDTH = 32

# Widths the kernels are specialised for are drawn from these buckets.
J_BUCKETS = (1, 2, 4, 8, 16, 32)


def pad_width(J: int) -> int:
    """The bucket a width J <= MAX_WIDTH is padded to."""
    for b in J_BUCKETS:
        if J <= b:
            return b
    raise ValueError(f"celerite width J={J} exceeds MAX_WIDTH={MAX_WIDTH}")


@dataclasses.dataclass(frozen=True)
class Config:
    """Global solver configuration.

    Attributes:
        core_dtype: ``"float64"`` runs ``gp_loglik`` in float64 whatever
            the inputs' dtype (inputs and parameters are upcast with
            ``.double()`` and the result is cast back), for stiff kernels
            whose float32 cancellation corrupts gradients (the
            eps-regularised ``Matern32Term``).  ``None`` computes in the
            inputs' dtype.
        device: where anything that is not yet a tensor (numbers, numpy
            arrays, lists) is placed when an entry point turns it into
            one.  The default is the card; with ``"cuda"`` and no GPU,
            PyTorch's own error surfaces.  Tensors the caller passes keep
            their device, and every entry point's ``device=`` argument
            overrides this field for one call.
        backend: the tier of the general ops (``factor``,
            ``factor_solve``, the four sweeps and their adjoints).
            ``"scan"`` is the sequential tier: the plain row loops on the
            CPU, the row kernels of ``csrc/general_ops.cu`` on the card.
            ``"assoc"`` is the blocked prefix tier of ``ops/assoc.py``:
            the doubling in plain PyTorch on the CPU, the prefix kernels
            of ``csrc/assoc_prefix.cu`` on the card.  ``"auto"`` picks by
            device, length, width and dtype (``ops/dispatch.py``).
        assoc_threshold: with ``"auto"``, send every system of at least
            this many rows to the assoc tier, on any device and in any
            dtype; ``None`` keeps the rule measured on the card.
    """

    core_dtype: Literal["float64"] | None = None
    device: str = "cuda"
    backend: Literal["auto", "scan", "assoc"] = "auto"
    assoc_threshold: int | None = None


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Replace fields of the global config; returns the new config."""
    global _config
    backend = kwargs.get("backend", _config.backend)
    if backend not in ("auto", "scan", "assoc"):
        raise ValueError(f"backend must be auto, scan or assoc, got {backend!r}")
    _config = dataclasses.replace(_config, **kwargs)
    return _config
