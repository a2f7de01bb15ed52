"""The op schema: one table describing every semiseparable op.

Counterpart (and own copy) of ``celerite2_tpu/ops/spec.py``: a single
source of truth for op signatures, used for shape and dtype VALIDATION
(:func:`validate_call`), for test parametrization across every op, and as
documentation of the dimension bindings.

Dimension symbols: ``N`` rows, ``J`` celerite width, ``K`` right-hand
sides, ``M`` secondary rows (general matmuls).  Every op also takes C
independent systems at once: all of its arguments then carry one more,
leading, axis of the same length (the chain axis ``C``).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["OpSpec", "OPS", "validate_call"]


class OpSpec(NamedTuple):
    name: str
    inputs: tuple  # (arg_name, shape_symbols) pairs


_T = ("t", ("N",))
_C = ("c", ("J",))

OPS = {
    "factor": OpSpec(
        name="factor",
        inputs=(_T, _C, ("a", ("N",)), ("U", ("N", "J")),
                ("V", ("N", "J"))),
    ),
    "factor_solve": OpSpec(
        name="factor_solve",
        inputs=(_T, _C, ("a", ("N",)), ("U", ("N", "J")),
                ("V", ("N", "J")), ("Y", ("N", "K"))),
    ),
    "solve_lower": OpSpec(
        name="solve_lower",
        inputs=(_T, _C, ("U", ("N", "J")), ("W", ("N", "J")),
                ("Y", ("N", "K"))),
    ),
    "solve_upper": OpSpec(
        name="solve_upper",
        inputs=(_T, _C, ("U", ("N", "J")), ("W", ("N", "J")),
                ("Y", ("N", "K"))),
    ),
    "matmul_lower": OpSpec(
        name="matmul_lower",
        inputs=(_T, _C, ("U", ("N", "J")), ("V", ("N", "J")),
                ("Y", ("N", "K"))),
    ),
    "matmul_upper": OpSpec(
        name="matmul_upper",
        inputs=(_T, _C, ("U", ("N", "J")), ("V", ("N", "J")),
                ("Y", ("N", "K"))),
    ),
    # rectangular cross-covariance products
    "general_matmul_lower": OpSpec(
        name="general_matmul_lower",
        inputs=(("t1", ("N",)), ("t2", ("M",)), _C,
                ("U", ("N", "J")), ("V", ("M", "J")),
                ("Y", ("M", "K"))),
    ),
    "general_matmul_upper": OpSpec(
        name="general_matmul_upper",
        inputs=(("t1", ("N",)), ("t2", ("M",)), _C,
                ("U", ("N", "J")), ("V", ("M", "J")),
                ("Y", ("M", "K"))),
    ),
    "to_dense": OpSpec(
        name="to_dense",
        inputs=(_T, _C, ("a", ("N",)), ("U", ("N", "J")),
                ("V", ("N", "J"))),
    ),
}


def _bind(sym, size, bindings, arg, errors):
    if sym in bindings:
        if bindings[sym] != size:
            errors.append(
                f"{arg}: dimension {sym}={size} conflicts with "
                f"{sym}={bindings[sym]}"
            )
    else:
        bindings[sym] = size


def validate_call(op_name: str, *args):
    """Check argument ranks, dimension consistency, dtype and device
    against the schema; returns the resolved ``{symbol: size}`` bindings
    (with ``"C"`` when the arguments carry the leading chain axis).

    The arguments are either all of the schema's rank (one system) or all
    one rank higher (C systems); they share one floating dtype and one
    device."""
    spec = OPS[op_name]
    if len(args) != len(spec.inputs):
        raise ValueError(
            f"{op_name} expects {len(spec.inputs)} arguments "
            f"({', '.join(n for n, _ in spec.inputs)}), got {len(args)}"
        )
    bindings: dict = {}
    errors: list = []
    extra = len(getattr(args[0], "shape", ())) - len(spec.inputs[0][1])
    lead = ("C",) if extra == 1 else ()
    for (arg_name, symbols), value in zip(spec.inputs, args):
        shape = tuple(getattr(value, "shape", ()))
        symbols = lead + symbols
        if len(shape) != len(symbols):
            errors.append(
                f"{arg_name}: expected rank {len(symbols)} "
                f"{symbols}, got shape {shape}"
            )
            continue
        for sym, size in zip(symbols, shape):
            _bind(sym, size, bindings, arg_name, errors)
    first = args[0]
    for (arg_name, _), value in zip(spec.inputs, args):
        if not getattr(value, "is_floating_point", lambda: False)():
            errors.append(f"{arg_name}: expected a floating-point tensor")
        elif value.dtype != first.dtype or value.device != first.device:
            errors.append(
                f"{arg_name}: {value.dtype} on {value.device} differs from "
                f"{spec.inputs[0][0]} ({first.dtype} on {first.device})"
            )
    if errors:
        raise ValueError(
            f"invalid arguments for {op_name}: " + "; ".join(errors)
        )
    return bindings
