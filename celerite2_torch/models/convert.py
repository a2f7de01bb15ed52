"""Build the port's terms, and its factorized state, from plain numpy
descriptions.

No JAX counterpart: this carries a kernel across from
``celerite2_tpu/models/terms.py``, and a ``GPState`` across from
``celerite2_tpu/gp.py``, without importing JAX.  The
description names each class and its parameters exactly as the JAX
classes' ``_params`` do::

    {"type": "SHOTerm", "params": {"w0": w0, "Q": Q, "S0": S0, "eps": eps}}
    {"type": "TermSum", "terms": [description, ...]}
    {"type": "TermProduct", "terms": [description, description]}
    {"type": "TermDiff", "term": description}
    {"type": "TermConvolution", "term": description, "delta": delta}
    {"type": "OriginalCeleriteTerm",
     "params": {"ar": ar, "cr": cr, "ac": ac, "bc": bc, "cc": cc, "dc": dc}}

where each parameter is anything ``numpy.asarray`` accepts.  From a JAX
term ``k`` the parameters are ``numpy.asarray(getattr(k, p))`` for ``p``
in ``k._params``.
"""

from __future__ import annotations

import numpy as np
import torch

from celerite2_torch.models import terms as _terms
from celerite2_torch.utils.misc import resolve_device

__all__ = ["term_from_numpy", "state_from_numpy"]

_PRIMITIVES = {
    "RealTerm": _terms.RealTerm,
    "ComplexTerm": _terms.ComplexTerm,
    "SHOTerm": _terms.SHOTerm,
    "Matern32Term": _terms.Matern32Term,
    "RotationTerm": _terms.RotationTerm,
}


class _Coefficients:
    """A stand-in for a celerite-v1 term: its six coefficient arrays."""

    def __init__(self, params):
        self._coeffs = tuple(params[k] for k in _terms.OriginalCeleriteTerm._params)

    def get_all_coefficients(self):
        return self._coeffs


def term_from_numpy(spec, *, device=None, dtype=torch.float64):
    """The port's term for the description ``spec`` (see the module
    docstring), with every parameter a tensor of ``dtype`` on ``device``
    (default: the package's ``Config.device``)."""
    device = resolve_device(device)
    kind = spec["type"]

    def tensor(value):
        return torch.as_tensor(np.asarray(value), device=device, dtype=dtype)

    def sub(s):
        return term_from_numpy(s, device=device, dtype=dtype)

    if kind == "TermSum":
        return _terms.TermSum(*(sub(s) for s in spec["terms"]))
    if kind == "TermProduct":
        return _terms.TermProduct(*(sub(s) for s in spec["terms"]))
    if kind == "TermDiff":
        return _terms.TermDiff(sub(spec["term"]))
    if kind == "TermConvolution":
        return _terms.TermConvolution(sub(spec["term"]), tensor(spec["delta"]))
    params = {name: tensor(value) for name, value in spec["params"].items()}
    if kind == "OriginalCeleriteTerm":
        return _terms.OriginalCeleriteTerm(_Coefficients(params))
    if kind not in _PRIMITIVES:
        raise NotImplementedError(f"no term of the port is called {kind}")
    return _PRIMITIVES[kind](**params)


def state_from_numpy(fields, *, device=None, dtype=torch.float64):
    """The port's ``GPState`` from the fields of a JAX ``GPState`` given as
    a mapping of numpy arrays (``{name: numpy.asarray(value) for name,
    value in state._asdict().items()}``): a system factorized by one
    package can be solved by the other.  Floating fields become ``dtype``
    on ``device`` (default: the package's ``Config.device``); ``ok`` stays
    boolean."""
    from celerite2_torch.gp import GPState

    device = resolve_device(device)
    missing = set(GPState._fields) - set(fields)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    return GPState(**{
        name: torch.as_tensor(
            np.array(fields[name]), device=device,  # a writable copy
            dtype=torch.bool if name == "ok" else dtype,
        )
        for name in GPState._fields
    })
