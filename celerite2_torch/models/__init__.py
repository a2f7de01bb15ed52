from celerite2_torch.models.convert import term_from_numpy
from celerite2_torch.models.terms import (
    ComplexTerm,
    Matern32Term,
    RealTerm,
    SHOTerm,
    Term,
    TermSum,
)

__all__ = [
    "Term",
    "TermSum",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "term_from_numpy",
]
