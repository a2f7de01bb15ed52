from celerite2_torch.models.convert import state_from_numpy, term_from_numpy
from celerite2_torch.models.terms import (
    ComplexTerm,
    Matern32Term,
    RealTerm,
    RotationTerm,
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
    "RotationTerm",
    "term_from_numpy",
    "state_from_numpy",
]
