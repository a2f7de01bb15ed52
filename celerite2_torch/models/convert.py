"""Build the port's terms from a plain description of their parameters.

No JAX counterpart: this carries a kernel across from
``celerite2_tpu/models/terms.py`` without importing JAX.  The
description names each class and its parameters exactly as the JAX
classes' ``_params`` do::

    {"type": "SHOTerm", "params": {"w0": w0, "Q": Q, "S0": S0, "eps": eps}}
    {"type": "TermSum", "terms": [description, ...]}

where each parameter is anything ``numpy.asarray`` accepts.  From a JAX
term ``k`` the parameters are ``numpy.asarray(getattr(k, p))`` for ``p``
in ``k._params``.
"""

from __future__ import annotations

import numpy as np
import torch

from celerite2_torch.models import terms as _terms

__all__ = ["term_from_numpy"]

_PRIMITIVES = {
    "RealTerm": _terms.RealTerm,
    "ComplexTerm": _terms.ComplexTerm,
    "SHOTerm": _terms.SHOTerm,
    "Matern32Term": _terms.Matern32Term,
    "RotationTerm": _terms.RotationTerm,
}


def term_from_numpy(spec, *, device=None, dtype=torch.float64):
    """The port's term for the description ``spec`` (see the module
    docstring), with every parameter a tensor on ``device`` of ``dtype``."""
    kind = spec["type"]
    if kind == "TermSum":
        return _terms.TermSum(
            *(
                term_from_numpy(s, device=device, dtype=dtype)
                for s in spec["terms"]
            )
        )
    if kind not in _PRIMITIVES:
        raise NotImplementedError(
            f"{kind} is not ported yet (ROADMAP.md Queue A, item A2)"
        )
    params = {
        name: torch.as_tensor(np.asarray(value), device=device, dtype=dtype)
        for name, value in spec["params"].items()
    }
    return _PRIMITIVES[kind](**params)
