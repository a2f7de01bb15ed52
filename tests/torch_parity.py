"""Shared helpers for the tests that hold celerite2_torch against the JAX
package (imported by tests/test_torch_*.py; not a test module)."""

import numpy as np
import torch

from celerite2_tpu.config import get_config, set_config


def spec_from_jax(term):
    """The ``term_from_numpy`` description of a JAX term."""
    name = type(term).__name__
    if name == "TermSum":
        return {"type": name, "terms": [spec_from_jax(t) for t in term.terms]}
    return {
        "type": name,
        "params": {p: np.asarray(getattr(term, p)) for p in term._params},
    }


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def assert_scaled_close(got, want, atol, name=""):
    """|got - want| <= atol * max|want| (the JAX package's
    test_fused_slab._check_parity convention for cotangents)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = np.max(np.abs(want)) + 1e-300
    np.testing.assert_allclose(
        got / scale, want / scale, rtol=0, atol=atol, err_msg=name
    )


class jax_config:
    """Context manager: set the JAX package's config, restore it after."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __enter__(self):
        self.prior = get_config()
        set_config(**self.kwargs)

    def __exit__(self, *exc):
        set_config(**self.prior.__dict__)
