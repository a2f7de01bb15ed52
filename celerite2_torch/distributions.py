"""A ``torch.distributions.Distribution`` over the observations of a GP.

Counterpart of ``celerite2_tpu/distributions.py``, whose numpyro adapter
(``CeleriteNormal``, ``gp_numpyro_dist``) becomes a PyTorch distribution
here: ``log_prob`` is :func:`~celerite2_torch.gp.gp_log_likelihood` and
``rsample`` (numpyro's reparameterized ``sample``) is
:func:`~celerite2_torch.gp.gp_dot_tril` of standard normals plus the mean.
PyTorch is always present, so the JAX package's stand-in base
(``_StubBase``) and its ImportError placeholder have no counterpart.
"""

from __future__ import annotations

import torch
from torch.distributions import Distribution, constraints

from celerite2_torch.gp import GPState, _log_likelihoods, gp_log_likelihood, gp_sample

__all__ = ["CeleriteNormal", "gp_distribution"]


class CeleriteNormal(Distribution):
    """The normal law of the observations of a computed GP.

    ``gp`` is a computed :class:`~celerite2_torch.gp.GaussianProcess` or a
    :class:`~celerite2_torch.gp.GPState`; a chain-axis state gives
    ``batch_shape (C,)``.  The event is the ``(N,)`` vector of
    observations.  Draws come from ``generator`` (a ``torch.Generator``;
    None draws from PyTorch's global one).
    """

    arg_constraints = {}
    support = constraints.real_vector
    has_rsample = True

    def __init__(self, gp, generator=None, validate_args=None):
        self.gp = gp
        self.state = gp if isinstance(gp, GPState) else gp.state
        self.generator = generator
        super().__init__(
            batch_shape=self.state.d.shape[:-1],
            event_shape=self.state.d.shape[-1:],
            validate_args=validate_args,
        )

    def rsample(self, sample_shape=torch.Size()):
        """Draws ``(*sample_shape, *batch_shape, N)``: L sqrt(d) z plus the
        mean, differentiable with respect to the GP's parameters."""
        sample_shape = tuple(sample_shape)
        draws = gp_sample(self.state, self.generator, shape=sample_shape)
        if not self.batch_shape:
            return draws
        # gp_sample puts the chain axis first
        return draws.movedim(0, len(sample_shape))

    def sample(self, sample_shape=torch.Size()):
        with torch.no_grad():
            return self.rsample(sample_shape)

    def log_prob(self, value):
        """The log-likelihood of ``value (*sample_shape, *batch_shape,
        N)``."""
        value = torch.as_tensor(value, dtype=self.state.t.dtype,
                                device=self.state.t.device)
        if self._validate_args:
            ev = tuple(self.event_shape)
            if tuple(value.shape)[-len(ev):] != ev:
                raise ValueError(
                    f"log_prob value trailing shape {tuple(value.shape)} "
                    f"does not match event_shape {ev}"
                )
        lead = value.shape[: value.dim() - len(self.batch_shape) - 1]
        if not lead:
            return gp_log_likelihood(self.state, value)
        # the sample axes become right-hand sides of one solve
        resid = (value - self.state.mean_value).reshape(-1, *self.state.d.shape)
        ll = _log_likelihoods(self.state, resid.movedim(0, -1))
        return ll.movedim(-1, 0).reshape(*lead, *self.batch_shape)


def gp_distribution(gp, generator=None, validate_args=None):
    """The counterpart of the JAX package's ``gp_numpyro_dist``."""
    return CeleriteNormal(gp, generator=generator, validate_args=validate_args)
