"""The port imports nothing of JAX or of the JAX package.

Every ``.py`` under ``celerite2_torch/`` and ``chip_smoke.py`` is parsed
with ``ast``; an ``import`` or ``from ... import`` of ``jax``, ``jaxlib``
or ``celerite2_tpu`` (or of a module inside them), or an
``importlib.import_module`` / ``__import__`` of one by a constant name,
fails the test.  The machine with the card has no JAX.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "celerite2_tpu")


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


def _imports(path):
    """``(line, module)`` of every forbidden import in ``path``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                found.append((node.lineno, arg.value))
    return found


@pytest.mark.parametrize("target", ["celerite2_torch", "chip_smoke.py"])
def test_port_imports_no_jax(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    offenders = [f"{f.relative_to(ROOT)}:{line} imports {module}"
                 for f in files for line, module in _imports(f)]
    assert not offenders, offenders


def test_guard_sees_every_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom celerite2_tpu.ops import fused_slab\n"
                 "import importlib\nimportlib.import_module('jaxlib')\n"
                 "from . import sibling\nimport jaxtyping\n")
    assert [m for _, m in _imports(f)] == ["jax.numpy", "celerite2_tpu.ops", "jaxlib"]
