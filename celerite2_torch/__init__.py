"""celerite2-torch: celerite-class Gaussian processes on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of ``celerite2_tpu`` (JAX on a TPU), which stays beside it as
the reference.  This package imports neither JAX nor ``celerite2_tpu``.
"""

from celerite2_torch import models, ops
from celerite2_torch.citation import CITATION_KEYS, CITATIONS, get_citations
from celerite2_torch.config import Config, get_config, set_config
from celerite2_torch.distributions import CeleriteNormal, gp_distribution
from celerite2_torch.gp import (
    ConditionalDistribution,
    ConstantMean,
    GaussianProcess,
    GPState,
    gp_apply_inverse,
    gp_compute,
    gp_dot_tril,
    gp_log_likelihood,
    gp_loglik,
    gp_sample,
    gp_sample_conditional,
)
from celerite2_torch.models import terms
from celerite2_torch.ops import factor_solve
from celerite2_torch.models.terms import (
    ComplexTerm,
    Matern32Term,
    RealTerm,
    OriginalCeleriteTerm,
    RotationTerm,
    SHOTerm,
    Term,
    TermConvolution,
    TermDiff,
    TermProduct,
    TermSum,
)
from celerite2_torch.utils import LinAlgError

__version__ = "0.1.0"

__all__ = [
    "terms",
    "models",
    "ops",
    "Config",
    "get_config",
    "set_config",
    "LinAlgError",
    "Term",
    "TermSum",
    "TermProduct",
    "TermDiff",
    "TermConvolution",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "RotationTerm",
    "OriginalCeleriteTerm",
    "ConstantMean",
    "GPState",
    "GaussianProcess",
    "ConditionalDistribution",
    "gp_compute",
    "gp_apply_inverse",
    "gp_dot_tril",
    "gp_log_likelihood",
    "gp_loglik",
    "gp_sample",
    "gp_sample_conditional",
    "factor_solve",
    "CeleriteNormal",
    "gp_distribution",
    "pymc_support",
    "CITATIONS",
    "CITATION_KEYS",
    "get_citations",
]


def __getattr__(name):
    # pymc_support imports pytensor where it is installed: only on demand
    if name == "pymc_support":
        import importlib

        return importlib.import_module("celerite2_torch.pymc_support")
    raise AttributeError(f"module 'celerite2_torch' has no attribute {name!r}")
