"""The port's layout probe against the JAX package's, on the CPU.

``celerite2_torch.probes.transpose`` and its kernels' plain versions
(``ops/layout.py``) against ``benchmarks/probe_transpose_tpu.py``, which
stays as it is: the slab geometry against ``fused_slab.Geom``, the plain
transposes against the probe's Pallas kernels in interpret mode (with the
probe's grid and BlockSpecs), and the probe's path against the values that
the probe's own ``main`` prints.  About 5 s.
"""

import contextlib
import functools
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from celerite2_torch.ops import layout
from celerite2_torch.probes import transpose as tp
from celerite2_tpu.ops import fused_slab

_PROBE_FILE = Path(__file__).resolve().parents[1] / "benchmarks" / "probe_transpose_tpu.py"
_spec = importlib.util.spec_from_file_location("probe_transpose_tpu", _PROBE_FILE)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

LANES = probe.LANES
EB = 4  # the probe's default block of planes

# The probe's arms under their labels in the port.
ARM_LABELS = {
    "noop (2-plane sum)": "noop (2-plane sum)",
    "sum pre-stacked": "sum pre-stacked",
    "stack only": "stack only",
    "stack+rowpad": "stack+rowpad",
    "copy (stack+pad only)": "copy (stack+pad only)",
    "xla-T (batched 5d)": "torch-T (batched 5d)",
    "xla-T2d (batched 2d)": "torch-T2d (batched 2d)",
    "pallas-T": "cuda-T",
    "pallas round trip": "cuda round trip",
}
# Each arm's value is a float32 sum of 60 000 normals (two planes of 5000
# for the noop) in another order than the probe's; the probe's own arms
# spread 5.4e-5 relative.
VAL_RTOL = 2e-4


@pytest.mark.parametrize("N", [1, 7, 8, 5000, 8191, 8192, 8193, 100_000, 1_000_000])
def test_geometry_matches_fused_slab(N):
    g = tp.SlabGeometry(N)
    want = fused_slab.Geom(N, jnp.float32)
    for name in ("L", "NB", "GB", "T", "s", "TOT"):
        assert getattr(g, name) == getattr(want, name), name
    assert g.LP == -(-want.L // LANES) * LANES
    assert g.T == 1


def _pallas_transpose(x, s):
    """The probe's ``make_pallas_T`` (:119-136) in interpret mode."""
    E, _, LP = x.shape
    return pl.pallas_call(
        functools.partial(probe.transpose_kernel, s=s),
        grid=(E // EB, 1, LP // LANES),
        in_specs=[pl.BlockSpec((EB, s * LANES, LANES), lambda e, t, lp: (e, t, lp))],
        out_specs=pl.BlockSpec((EB, LANES, s, LANES), lambda e, t, lp: (e, lp, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((E, LP, s, LANES), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary", "arbitrary")),
        interpret=True,
    )(x)


def _pallas_inverse(y):
    """The probe's ``make_pallas_inv`` (:144-161) in interpret mode."""
    E, LP, s, _ = y.shape
    return pl.pallas_call(
        functools.partial(probe.inv_transpose_kernel, s=s),
        grid=(E // EB, 1, LP // LANES),
        in_specs=[pl.BlockSpec((EB, LANES, s, LANES), lambda e, t, lp: (e, lp, 0, 0))],
        out_specs=pl.BlockSpec((EB, s * LANES, LANES), lambda e, t, lp: (e, t, lp)),
        out_shape=jax.ShapeDtypeStruct((E, s * LANES, LP), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary", "arbitrary")),
        interpret=True,
    )(y)


@functools.lru_cache(maxsize=None)
def _planes(N):
    """Seeded float32 planes at the probe's geometry for N: natural ``(E,
    TOT, LP)`` and slab ``(E, LP, s, 128)``, independent of each other."""
    g = tp.SlabGeometry(N)
    rng = np.random.default_rng(N)
    x = rng.standard_normal((tp.E, g.TOT, g.LP)).astype(np.float32)
    y = rng.standard_normal((tp.E, g.LP, g.s, LANES)).astype(np.float32)
    return g, x, y


@pytest.mark.parametrize("direction", ["transpose", "inverse", "round trip"])
@pytest.mark.parametrize("N", [5000, 100_000, 200_000])
def test_plain_layouts_match_probe_kernels(N, direction):
    """Bit for bit: a transpose moves values and computes nothing.  N =
    5000 and 1e5 give one 128-step block of the TPU grid (LP = 128), N =
    2e5 two (LP = 256)."""
    g, x, y = _planes(N)
    if direction == "transpose":
        got = layout.slab_transpose(torch.from_numpy(x), g.s)
        want = np.asarray(_pallas_transpose(jnp.asarray(x), g.s))
    elif direction == "inverse":
        got = layout.slab_inverse(torch.from_numpy(y))
        want = np.asarray(_pallas_inverse(jnp.asarray(y)))
    else:
        got = layout.slab_inverse(layout.slab_transpose(torch.from_numpy(x), g.s))
        want = np.asarray(_pallas_inverse(_pallas_transpose(jnp.asarray(x), g.s)))
        np.testing.assert_array_equal(want, x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_layouts_refuse_more_than_one_tile():
    x = torch.zeros(4, 2 * LANES, LANES)
    with pytest.raises(ValueError, match="one tile"):
        layout.slab_transpose(x, 1)
    with pytest.raises(ValueError, match="one tile"):
        layout.slab_inverse(torch.zeros(4, LANES, 1, 2 * LANES))
    # the plain versions take any split of the rows, as the kernels do
    y = layout.slab_transpose_plain(x, 1)
    assert y.shape == (4, LANES, 1, 2 * LANES)
    assert torch.equal(layout.slab_inverse_plain(y), x)


def test_wrappers_refuse_cpu_tensors():
    from celerite2_torch.ops import _build

    with pytest.raises(ValueError, match="CUDA"):
        _build.slab_transpose_cuda(torch.zeros(4, LANES, LANES), 1)
    with pytest.raises(ValueError, match="CUDA"):
        _build.slab_inverse_cuda(torch.zeros(4, LANES, 1, LANES))


def _probe_values():
    """The ``val=`` each arm of the probe's unchanged ``main(5000, 2)``
    prints, run on the CPU in interpret mode."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pltpu.force_tpu_interpret_mode():
        probe.main(5000, 2)
    values = dict(re.findall(r"^(.+?): [\d.]+ ms/eval .*val=([-\d.]+)\)$",
                             out.getvalue(), re.M))
    assert sorted(values) == sorted(ARM_LABELS), out.getvalue()
    return {ARM_LABELS[k]: float(v) for k, v in values.items()}


@pytest.fixture(scope="module")
def probe_runs():
    """The JAX probe's printed values, and the port's probe on the CPU."""
    return _probe_values(), tp.main(5000, 2, device="cpu")


@pytest.mark.parametrize("label", list(ARM_LABELS.values()))
def test_probe_arm_matches_jax_probe(probe_runs, label):
    want, run = probe_runs
    reading = run["arms"][label]
    assert reading["val"] == pytest.approx(want[label], rel=VAL_RTOL)
    # the plain versions on the CPU launch no kernel
    assert reading["launches"] == {"slab_transpose": 0.0, "slab_inverse": 0.0}
    assert reading["ms"] > 0


def test_probe_layouts(probe_runs):
    _, run = probe_runs
    lay, g = run["layouts"], run["geometry"]
    assert run["device"] == "cpu"
    assert lay["natural"].shape == (tp.E, g.TOT, g.LP)
    assert lay["cuda-T"].shape == (tp.E, g.LP, g.s, LANES)
    assert torch.equal(lay["cuda-T"], lay["torch-T2d (batched 2d)"])
    assert torch.equal(lay["cuda round trip"], lay["natural"])
