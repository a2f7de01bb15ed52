"""Shared test fixtures and cross-backend comparators.

Counterpart of ``celerite2_tpu/testing.py`` (role of the reference's
python/celerite2/testing.py: get_matrices:10-49, check_tensor_term:71-180,
check_gp_models:183-201).  Where the reference compares its NumPy, JAX and
PyMC backends, this compares the port's tiers of the general ops ("scan"
and "assoc", ``set_config(backend=...)``) against each other.  Inputs are
NumPy arrays; each term computes on its parameters' device, and every
result comes back as a NumPy array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["get_matrices", "check_term", "check_gp_backends"]


def _device(term):
    """The device of a term's parameters."""
    return term.get_coefficients()[0].device


def _on(term, *arrays):
    """The arrays as float64 tensors on ``term``'s device."""
    device = _device(term)
    return tuple(torch.as_tensor(a, dtype=torch.float64, device=device) for a in arrays)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_matrices(
    size=100,
    J=None,
    kernel=None,
    vector=False,
    conditional=False,
    include_dense=False,
    no_diag=False,
    seed=721,
):
    """Deterministic random celerite system (cf. reference
    testing.py:10-49): the JAX package's arrays for the same arguments and
    seed, as NumPy arrays.  The default kernel is built on the CPU."""
    from celerite2_torch.models.terms import SHOTerm

    random = np.random.default_rng(seed)
    t = np.sort(random.uniform(0, 10, size))
    if no_diag:
        diag = np.zeros_like(t)
    else:
        diag = random.uniform(0.1, 0.3, len(t))

    if kernel is None:
        S0, w0, Q = (torch.tensor(v, dtype=torch.float64) for v in (5.0, 0.1, 3.45))
        S1, w1, Q1 = (torch.tensor(v, dtype=torch.float64) for v in (1.0, 2.5, 0.2))
        kernel = SHOTerm(S0=S0, w0=w0, Q=Q) + SHOTerm(S0=S1, w0=w1, Q=Q1)
    c, a, U, V = map(_np, kernel.get_celerite_matrices(*_on(kernel, t, diag)))

    nrhs = 1 if vector else 4
    Y = random.normal(size=(len(t), nrhs))
    if vector:
        Y = Y[:, 0]

    out = [t, c, a, U, V, Y]

    if conditional:
        t2 = np.sort(random.uniform(-2, 12, 75))
        c2, a2, U2, V2 = map(_np, kernel.get_celerite_matrices(
            *_on(kernel, t2, np.zeros_like(t2))))
        out += [t2, U2, V2]

    if include_dense:
        out.append(_np(kernel.to_dense(*_on(kernel, t, diag))))
        if conditional:
            out.append(_np(kernel.get_value(*_on(kernel, t[:, None] - t2[None, :]))))

    return tuple(out)


def check_term(term, ref_term, x=None, tau=None, omega=None, atol=1e-8):
    """Compare two Term implementations over the full term surface
    (kernel values, PSD, dense matrix, matmul): the analogue of the
    reference's cross-backend ``check_tensor_term`` (testing.py:71-180)."""
    random = np.random.default_rng(40582)
    if x is None:
        x = np.sort(random.uniform(0, 10, 50))
    if tau is None:
        tau = x[:, None] - x[None, :]
    if omega is None:
        omega = np.linspace(-10, 10, 100)
    diag = random.uniform(0.1, 0.4, len(x))
    y = random.normal(size=(len(x), 3))

    for name, args in (("get_value", (tau,)), ("get_psd", (omega,)),
                       ("to_dense", (x, diag)), ("dot", (x, diag, y))):
        np.testing.assert_allclose(
            _np(getattr(term, name)(*_on(term, *args))),
            _np(getattr(ref_term, name)(*_on(ref_term, *args))),
            atol=atol, err_msg=name,
        )


def check_gp_backends(kernel, backends=("scan", "assoc"), *, size=120, atol=1e-8):
    """Full GP-surface parity across the tiers of the general ops (analogue
    of the reference's ``check_gp_models``, testing.py:183-201): for each
    backend, the log-likelihood, the conditional mean and variance at new
    points, two prior draws from one seed and ``apply_inverse``, on the
    kernel's device.  Returns ``{backend: {name: array}}``."""
    from celerite2_torch.config import get_config, set_config
    from celerite2_torch.gp import GaussianProcess

    random = np.random.default_rng(1986)
    t = np.sort(random.uniform(0, 10, size))
    yerr = random.uniform(0.1, 0.3, size)
    y = np.sin(t) + yerr * random.normal(size=size)
    t_new = np.linspace(-1, 11, 60)
    t, yerr, y, t_new = _on(kernel, t, yerr, y, t_new)
    device = _device(kernel)

    results = {}
    prior = get_config()
    try:
        for backend in backends:
            set_config(backend=backend, assoc_threshold=1)
            gp = GaussianProcess(kernel, t=t, yerr=yerr, device=device)
            cond = gp.condition(y, t=t_new)
            results[backend] = {
                "loglike": _np(gp.log_likelihood(y)),
                "mean": _np(cond.mean),
                "variance": _np(cond.variance),
                "sample": _np(gp.sample(torch.Generator(device).manual_seed(0), size=2)),
                "apply_inverse": _np(gp.apply_inverse(y)),
            }
    finally:
        # restore whatever config the caller had
        set_config(**dataclasses.asdict(prior))

    ref = results[backends[0]]
    for backend in backends[1:]:
        for name, val in results[backend].items():
            np.testing.assert_allclose(
                val, ref[name], atol=atol,
                err_msg=f"{backend} vs {backends[0]}: {name}",
            )
    return results
