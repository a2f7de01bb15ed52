from celerite2_torch.ops.api import (
    factor,
    factor_solve,
    general_matmul_lower,
    general_matmul_upper,
    matmul_lower,
    matmul_upper,
    solve_lower,
    solve_upper,
    to_dense,
)
from celerite2_torch.ops.fused_loglik import LAUNCHES, LoglikFused, loglik_fused

__all__ = [
    "LAUNCHES",
    "LoglikFused",
    "loglik_fused",
    "factor",
    "factor_solve",
    "solve_lower",
    "solve_upper",
    "matmul_lower",
    "matmul_upper",
    "general_matmul_lower",
    "general_matmul_upper",
    "to_dense",
]
