from celerite2_torch.models.convert import state_from_numpy, term_from_numpy
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

__all__ = [
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
    "term_from_numpy",
    "state_from_numpy",
]
