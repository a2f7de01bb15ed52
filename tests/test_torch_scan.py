"""The port's row recursions (celerite2_torch.ops.scan: the plain versions
of the factor, sweep, factor adjoint, sweep adjoint and affine prefix
kernels) against the JAX package, float64 on the CPU: against the scan
tier (celerite2_tpu.ops.scan) and against the TPU kernels they replace,
run in interpret mode (pallas_kernels.* tiled, pallas_packed.*
lane-packed, and the prefix engine's in-block kernel).  Values, caches and
cotangents agree to 1e-10 relative to each array's largest entry (1e-9
against the TPU kernels' adjoints, tests/test_pallas.py's tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celerite2_torch.ops import scan as tscan
from celerite2_tpu.ops import pallas_kernels as pk
from celerite2_tpu.ops import pallas_packed as pp
from celerite2_tpu.ops import scan as jscan
from torch_parity import (
    WIDTHS, assert_rel_close, chains, jax_config, t64, wide_system,
)

RTOL = 1e-10
N = 101  # odd: ragged against every block size
BLOCK = 16  # the Pallas tests' block: several grid steps and padding
SWEEPS = ["solve_lower", "solve_upper", "matmul_lower", "matmul_upper"]
# name -> (is_solve, upper); the upper sweeps project with the second
# matrix and feed the carry with U
MODES = {"solve_lower": (True, False), "solve_upper": (True, True),
         "matmul_lower": (False, False), "matmul_upper": (False, True)}
REV_WIDTHS = [1, 2, 3, 4, 8, 16]
FACTOR_COTANGENTS = ("bt", "bc", "ba", "bU", "bV")
SWEEP_COTANGENTS = ("bt", "bc", "bA", "bB", "bY")


def _jax_factor(sys_):
    t, c, a, U, V, _ = map(jnp.asarray, sys_)
    return jscan.factor_scan(t, c, a, U, V)


def _second(op, sys_, W):
    """The second matrix of a sweep: W for the solves, V for the matmuls."""
    return np.asarray(W) if op.startswith("solve") else sys_[4]


@pytest.mark.parametrize("J", WIDTHS)
def test_factor_matches_jax_scan(J):
    sys_ = wide_system(N, J, 1, seed=J)
    want = _jax_factor(sys_)
    t, c, a, U, V, _ = chains(sys_)
    got = tscan.factor_scan(t, c, a, U, V)
    for g, w, name in zip(got, want, ("d", "W", "S_half")):
        assert_rel_close(g[0], w, RTOL, name)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("J", WIDTHS)
@pytest.mark.parametrize("op", SWEEPS)
def test_sweeps_match_jax_scan(op, J, K):
    sys_ = wide_system(N, J, K, seed=10 + J)
    second = _second(op, sys_, _jax_factor(sys_)[1])
    t, c, _, U, _, Y = sys_
    want = getattr(jscan, op + "_scan")(*map(jnp.asarray, (t, c, U, second, Y)))
    got = getattr(tscan, op + "_scan")(*chains((t, c, U, second, Y)))
    for g, w, name in zip(got, want, ("Z", "F")):
        assert_rel_close(g[0], w, RTOL, f"{op} {name}")


@pytest.mark.parametrize("J", WIDTHS)
def test_factor_matches_tiled_tpu_kernel(J):
    """pallas_kernels.factor_pallas in interpret mode, as
    tests/test_pallas.py runs it."""
    sys_ = wide_system(N, J, 1, seed=20 + J)
    t, c, a, U, V, _ = map(jnp.asarray, sys_)
    want = pk.factor_pallas(t, c, a, U, V, block_size=BLOCK)
    tt, tc, ta, tU, tV, _ = chains(sys_)
    got = tscan.factor_scan(tt, tc, ta, tU, tV)
    for g, w, name in zip(got, want, ("d", "W", "S_half")):
        assert_rel_close(g[0], w, RTOL, name)


@pytest.mark.parametrize("J, K", [(1, 1), (2, 4), (3, 1), (5, 4), (8, 1), (16, 4)])
@pytest.mark.parametrize("op", SWEEPS)
def test_sweeps_match_tiled_tpu_kernel(op, J, K):
    sys_ = wide_system(N, J, K, seed=30 + J)
    second = _second(op, sys_, _jax_factor(sys_)[1])
    t, c, _, U, _, Y = sys_
    want = getattr(pk, op + "_pallas")(
        *map(jnp.asarray, (t, c, U, second, Y)), block_size=BLOCK)
    got = getattr(tscan, op + "_scan")(*chains((t, c, U, second, Y)))
    for g, w, name in zip(got, want, ("Z", "F")):
        assert_rel_close(g[0], w, RTOL, f"{op} {name}")


@pytest.mark.parametrize("J", [1, 2, 3, 5, 8])
def test_factor_matches_packed_tpu_kernel(J):
    """pallas_packed.factor_packed (J <= 8) in interpret mode: its cache
    pair (Sh, ShT) is S_half padded to a power of two, and its transpose."""
    sys_ = wide_system(N, J, 1, seed=40 + J)
    t, c, a, U, V, _ = map(jnp.asarray, sys_)
    d, W, (Sh, ShT) = pp.factor_packed(t, c, a, U, V, block_size=BLOCK)
    Jp = pp._pow2_width(J)
    tt, tc, ta, tU, tV, _ = chains(sys_)
    gd, gW, gS = (x[0] for x in tscan.factor_scan(tt, tc, ta, tU, tV))
    assert_rel_close(gd, d, RTOL, "d")
    assert_rel_close(gW, W, RTOL, "W")
    padded = torch.nn.functional.pad(gS, (0, Jp - J, 0, Jp - J))
    assert_rel_close(padded.reshape(N, Jp * Jp), Sh, RTOL, "Sh")
    assert_rel_close(padded.mT.reshape(N, Jp * Jp), ShT, RTOL, "ShT")


@pytest.mark.parametrize("J", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("op", SWEEPS)
def test_sweeps_match_packed_tpu_kernel(op, J):
    """pallas_packed's sweeps (J <= 8, K = 1) in interpret mode."""
    sys_ = wide_system(N, J, 1, seed=50 + J)
    second = _second(op, sys_, _jax_factor(sys_)[1])
    t, c, _, U, _, Y = sys_
    want = getattr(pp, op + "_packed")(
        *map(jnp.asarray, (t, c, U, second, Y)), block_size=BLOCK)
    got = getattr(tscan, op + "_scan")(*chains((t, c, U, second, Y)))
    for g, w, name in zip(got, want, ("Z", "F")):
        assert_rel_close(g[0], np.asarray(w).reshape(g[0].shape), RTOL,
                         f"{op} {name}")


@pytest.mark.parametrize("J", [2, 5, 16])
def test_chains_match_a_loop(J):
    """C = 3 systems in one call (different kernels and right-hand sides)
    against the JAX scan tier chain by chain."""
    systems = [wide_system(N, J, 2, seed=60 + k, sigma=1.0 + 0.3 * k)
               for k in range(3)]
    t, c, a, U, V, Y = (torch.stack([t64(s[i]) for s in systems])
                        for i in range(6))
    d, W, S = tscan.factor_scan(t, c, a, U, V)
    outs = {op: getattr(tscan, op + "_scan")(
        t, c, U, W if op.startswith("solve") else V, Y) for op in SWEEPS}
    for k, s in enumerate(systems):
        jd, jW, jS = _jax_factor(s)
        for g, w, name in ((d, jd, "d"), (W, jW, "W"), (S, jS, "S_half")):
            assert_rel_close(g[k], w, RTOL, f"chain {k} {name}")
        for op in SWEEPS:
            second = jW if op.startswith("solve") else jnp.asarray(s[4])
            jZ, jF = getattr(jscan, op + "_scan")(
                jnp.asarray(s[0]), jnp.asarray(s[1]), jnp.asarray(s[3]),
                second, jnp.asarray(s[5]))
            assert_rel_close(outs[op][0][k], jZ, RTOL, f"chain {k} {op} Z")
            assert_rel_close(outs[op][1][k], jF, RTOL, f"chain {k} {op} F")


def test_transport_matches_jax():
    t, c = wide_system(N, 5, 1)[:2]
    assert_rel_close(tscan.transport(t64(t), t64(c)),
                     jscan.transport(jnp.asarray(t), jnp.asarray(c)), 1e-14)
    assert_rel_close(tscan.transport_up(t64(t), t64(c)),
                     jscan.transport_up(jnp.asarray(t), jnp.asarray(c)), 1e-14)
    # one row: nothing propagates, and the row is there
    for fn in (tscan.transport, tscan.transport_up):
        one = fn(t64(t[:1])[None], t64(c)[None])
        assert one.shape == (1, 1, 5) and torch.all(one == 0)


def test_nonpositive_pivot_divides_by_one():
    """A non-PD system stays finite (the guarded division of the quiet
    semantics) and equals the JAX scan tier."""
    t, c, a, U, V, _ = wide_system(N, 2, 1, seed=3)
    # the last rows only: a recursion that has left the PD cone amplifies
    # rounding from there on, so an early failure is no 1e-10 comparison
    a = a.copy()
    a[-4:] -= 5.0
    want = jscan.factor_scan(*map(jnp.asarray, (t, c, a, U, V)))
    got = tscan.factor_scan(*chains((t, c, a, U, V)))
    assert (np.asarray(want[0]) <= 0).any()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_rel_close(g[0], w, RTOL)


# ------------------------------------------------------------- adjoints


def _factor_rev_inputs(sys_, seed):
    """``(t, c, a, U, V, d, W, S, bd, bW)`` as JAX arrays: the system, the
    JAX scan tier's factor and random cotangents."""
    t, c, a, U, V, _ = map(jnp.asarray, sys_)
    d, W, S = jscan.factor_scan(t, c, a, U, V)
    rng = np.random.default_rng(seed)
    bd, bW = (jnp.asarray(rng.normal(size=x.shape)) for x in (d, W))
    return t, c, a, U, V, d, W, S, bd, bW


def _sweep_rev_inputs(op, sys_, seed):
    """``(t, c, A, B, Y, Z, F, bZ)`` of a sweep as the adjoint takes it:
    ``A`` projects, ``B`` feeds the carry."""
    is_solve, upper = MODES[op]
    t, c, a, U, V, Y = map(jnp.asarray, sys_)
    second = jscan.factor_scan(t, c, a, U, V)[1] if is_solve else V
    A, B = (second, U) if upper else (U, second)
    Z, F = jscan._sweep(t, c, A, B, Y, is_solve=is_solve, upper=upper)
    bZ = jnp.asarray(np.random.default_rng(seed).normal(size=Z.shape))
    return t, c, A, B, Y, Z, F, bZ


def _torch_sweep_rev(op, args):
    is_solve, upper = MODES[op]
    return tscan.sweep_rev_scan(*chains(args), is_solve=is_solve, upper=upper)


@pytest.mark.parametrize("J", REV_WIDTHS)
def test_factor_rev_matches_jax_scan(J):
    args = _factor_rev_inputs(wide_system(N, J, 1, seed=100 + J), seed=J)
    want = jscan.factor_rev_scan(*args)
    got = tscan.factor_rev_scan(*chains(args))
    for g, w, name in zip(got, want, FACTOR_COTANGENTS):
        assert_rel_close(g[0], w, RTOL, name)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("J", REV_WIDTHS)
@pytest.mark.parametrize("op", SWEEPS)
def test_sweep_rev_matches_jax_scan(op, J, K):
    args = _sweep_rev_inputs(op, wide_system(N, J, K, seed=110 + J), seed=K)
    is_solve, upper = MODES[op]
    want = jscan.sweep_rev_scan(*args, is_solve=is_solve, upper=upper)
    got = _torch_sweep_rev(op, args)
    for g, w, name in zip(got, want, SWEEP_COTANGENTS):
        assert_rel_close(g[0], w, RTOL, f"{op} {name}")


@pytest.mark.parametrize("J", [2, 8])
def test_factor_solve_matches_jax_scan(J):
    """The fused factor and lower solve (both caches) against
    jscan.factor_solve_scan, and against the factor then the solve."""
    sys_ = wide_system(N, J, 2, seed=120 + J)
    want = jscan.factor_solve_scan(*map(jnp.asarray, sys_))
    got = tscan.factor_solve_scan(*chains(sys_))
    for g, w, name in zip(got, want, ("d", "W", "Z", "S_half", "F")):
        assert_rel_close(g[0], w, RTOL, name)
    t, c, a, U, V, Y = chains(sys_)
    p = tscan.transport(t, c)
    d, W, S = tscan.factor_fwd_plain(p, a, U, V)
    Z, F = tscan.sweep_fwd_plain(p, U, W, Y, is_solve=True, upper=False)
    for g, w in zip(got, (d, W, Z, S, F)):
        assert torch.allclose(g, w, rtol=1e-13, atol=0)


RTOL_PALLAS = 1e-9


@pytest.mark.parametrize("J", [1, 2, 5, 8])
def test_factor_rev_matches_tiled_tpu_kernel(J):
    """pallas_kernels.factor_rev_pallas (K9) in interpret mode."""
    args = _factor_rev_inputs(wide_system(N, J, 1, seed=130 + J), seed=J)
    want = pk.factor_rev_pallas(*args, block_size=BLOCK)
    got = tscan.factor_rev_scan(*chains(args))
    for g, w, name in zip(got, want, FACTOR_COTANGENTS):
        assert_rel_close(g[0], w, RTOL_PALLAS, name)


@pytest.mark.parametrize("J, K", [(1, 1), (3, 2), (8, 1)])
@pytest.mark.parametrize("op", SWEEPS)
def test_sweep_rev_matches_tiled_tpu_kernel(op, J, K):
    """pallas_kernels.sweep_rev_pallas (K10) in interpret mode."""
    args = _sweep_rev_inputs(op, wide_system(N, J, K, seed=140 + J), seed=K)
    is_solve, upper = MODES[op]
    want = pk.sweep_rev_pallas(*args, is_solve=is_solve, upper=upper,
                               block_size=BLOCK)
    for g, w, name in zip(_torch_sweep_rev(op, args), want, SWEEP_COTANGENTS):
        assert_rel_close(g[0], w, RTOL_PALLAS, f"{op} {name}")


@pytest.mark.parametrize("J", [1, 3, 8])
def test_factor_rev_matches_packed_tpu_kernel(J):
    """pallas_packed.factor_rev_packed (K13) in interpret mode, on the
    cache pair (Sh, ShT) of pallas_packed.factor_packed."""
    t, c, a, U, V, _ = map(jnp.asarray, wide_system(N, J, 1, seed=150 + J))
    d, W, pair = pp.factor_packed(t, c, a, U, V, block_size=BLOCK)
    rng = np.random.default_rng(J)
    bd, bW = (jnp.asarray(rng.normal(size=x.shape)) for x in (d, W))
    want = pp.factor_rev_packed(t, c, a, U, V, d, W, pair, bd, bW,
                                block_size=BLOCK)
    S = jscan.factor_scan(t, c, a, U, V)[2]
    got = tscan.factor_rev_scan(*chains((t, c, a, U, V, d, W, S, bd, bW)))
    for g, w, name in zip(got, want, FACTOR_COTANGENTS):
        assert_rel_close(g[0], w, RTOL_PALLAS, name)


@pytest.mark.parametrize("J", [2, 5])
@pytest.mark.parametrize("op", SWEEPS)
def test_sweep_rev_matches_packed_tpu_kernel(op, J):
    """pallas_packed.sweep_rev_packed (K14, K = 1) in interpret mode."""
    args = _sweep_rev_inputs(op, wide_system(N, J, 1, seed=160 + J), seed=J)
    is_solve, upper = MODES[op]
    want = pp.sweep_rev_packed(*args, is_solve=is_solve, upper=upper,
                               block_size=BLOCK)
    for g, w, name in zip(_torch_sweep_rev(op, args), want, SWEEP_COTANGENTS):
        assert_rel_close(g[0], np.asarray(w).reshape(g[0].shape), RTOL_PALLAS,
                         f"{op} {name}")


@pytest.mark.parametrize("J", [3, 8])
def test_adjoint_chains_match_a_loop(J):
    """C = 3 systems through factor_bwd_plain and sweep_bwd_plain in one
    call against the JAX scan tier's adjoints chain by chain."""
    inputs = [_factor_rev_inputs(wide_system(N, J, 2, seed=170 + k,
                                             sigma=1.0 + 0.3 * k), seed=k)
              for k in range(3)]
    stacked = [torch.stack([t64(x[i]) for x in inputs]) for i in range(10)]
    got = tscan.factor_rev_scan(*stacked)
    for k, args in enumerate(inputs):
        for g, w, name in zip(got, jscan.factor_rev_scan(*args),
                              FACTOR_COTANGENTS):
            assert_rel_close(g[k], w, RTOL, f"chain {k} {name}")
    for op in ("solve_lower", "matmul_upper"):
        inputs = [_sweep_rev_inputs(op, wide_system(N, J, 2, seed=180 + k,
                                                    sigma=1.0 + 0.3 * k), seed=k)
                  for k in range(3)]
        stacked = [torch.stack([t64(x[i]) for x in inputs]) for i in range(8)]
        is_solve, upper = MODES[op]
        got = tscan.sweep_rev_scan(*stacked, is_solve=is_solve, upper=upper)
        for k, args in enumerate(inputs):
            want = jscan.sweep_rev_scan(*args, is_solve=is_solve, upper=upper)
            for g, w, name in zip(got, want, SWEEP_COTANGENTS):
                assert_rel_close(g[k], w, RTOL, f"chain {k} {op} {name}")


def test_cpu_route_is_the_plain_version_and_other_devices_raise():
    """On CPU tensors the wrappers take the plain loop; on any other device
    they go to the kernel's checked wrapper, which refuses what is not
    CUDA (no silent use of the plain loop)."""
    t, c, a, U, V, Y = chains(wide_system(31, 2, 1))
    p = tscan.transport(t, c)
    d, W, S = tscan.factor_fwd(p, a, U, V, want_cache=True)
    for g, w in zip((d, W, S), tscan.factor_fwd_plain(p, a, U, V)):
        assert torch.equal(g, w)
    assert tscan.factor_fwd(p, a, U, V)[2] is None
    Z, F = tscan.sweep_fwd(p, U, W, Y, is_solve=True, upper=False,
                           want_cache=True)
    assert tscan.sweep_fwd(p, U, W, Y, is_solve=True, upper=False)[1] is None
    Zp, Fp = tscan.sweep_fwd_plain(p, U, W, Y, is_solve=True, upper=False)
    assert torch.equal(Z, Zp) and torch.equal(F, Fp)
    meta = [x.to("meta") for x in (p, a, U, V)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.factor_fwd(*meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.sweep_fwd(meta[0], meta[2], meta[3], Y.to("meta"),
                        is_solve=False, upper=True)
    bd, bW = torch.ones_like(d), torch.ones_like(W)
    for g, w in zip(tscan.factor_bwd(p, d, U, W, S, bd, bW),
                    tscan.factor_bwd_plain(p, d, U, W, S, bd, bW)):
        assert torch.equal(g, w)
    for g, w in zip(tscan.sweep_bwd(p, U, W, Z, F, Y, is_solve=True, upper=False),
                    tscan.sweep_bwd_plain(p, U, W, Z, F, Y, is_solve=True,
                                          upper=False)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.factor_bwd(*(x.to("meta") for x in (p, d, U, W, S, bd, bW)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.sweep_bwd(*(x.to("meta") for x in (p, U, W, Z, F, Y)),
                        is_solve=False, upper=True)
    G = (V[..., None] * Y[..., None, :]).contiguous()
    assert torch.equal(tscan.affine_prefix(p, G), tscan.affine_prefix_plain(p, G))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.affine_prefix(meta[0], G.to("meta"))


@pytest.mark.parametrize("name", ["affine_prefix", "factor", "sweep_fwd "])
def test_ring_plan_refuses_a_kernel_without_a_ring(name):
    """The query of the row kernels' tile rings names its kernel: anything
    but the four row kernels is refused on the host, before the library
    is built or a card is asked."""
    from celerite2_torch.ops import _build

    assert _build.RING_KERNELS == ("factor_fwd", "sweep_fwd", "factor_bwd",
                                   "sweep_bwd")
    with pytest.raises(ValueError, match="is not one of"):
        _build.ring(name, torch.float64, 8)


@pytest.fixture
def prefix_engine_on(monkeypatch):
    """Route the JAX package's prefix scans through its TPU prefix engine
    (planes_engine, in interpret mode off a TPU), with the leaf shrunk so
    that a small M reaches the in-block prefix kernel, as tests/test_planes.py
    runs it."""
    from celerite2_tpu.ops import planes_engine

    monkeypatch.setattr(planes_engine, "_LEAF", 16)
    with jax_config(planes="on"):
        yield


def _affine_inputs(M, J, K, seed):
    rng = np.random.default_rng(seed)
    t, c = wide_system(M, J, 1, seed=seed)[:2]
    V = rng.normal(size=(M, J))
    Y = rng.normal(size=(M, K))
    return t, c, V[:, :, None] * Y[:, None, :]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M, J, K", [(1, 1, 1), (37, 3, 2), (97, 8, 1)])
def test_affine_prefix_matches_jax(M, J, K, reverse):
    """Against assoc._diag_affine_scan on the generic engine and against
    the sequential recurrence of the JAX package's scan tier."""
    from celerite2_tpu.ops import api as japi
    from celerite2_tpu.ops import assoc

    t, c, G = _affine_inputs(M, J, K, seed=80 + M)
    phi = (jscan.transport_up if reverse else jscan.transport)(
        jnp.asarray(t), jnp.asarray(c))
    with jax_config(planes="off"):
        want = assoc._diag_affine_scan(
            jnp.broadcast_to(phi[:, :, None], G.shape), jnp.asarray(G),
            reverse=reverse)
    with jax_config(backend="scan"):
        seq = japi._transported_cumulative(phi, jnp.asarray(G), reverse=reverse)
    got = tscan.affine_prefix_plain(t64(phi)[None], t64(G)[None], reverse=reverse)
    assert_rel_close(got[0], want, RTOL, "generic engine")
    assert_rel_close(got[0], seq, RTOL, "scan tier")


@pytest.mark.parametrize("reverse", [False, True])
def test_affine_prefix_matches_tpu_prefix_kernel(prefix_engine_on, reverse):
    """Against the TPU prefix engine's in-block prefix kernel
    (planes_engine._block_prefix_kernel) in interpret mode."""
    from celerite2_tpu.ops import assoc

    M, J, K = 97, 4, 1
    t, c, G = _affine_inputs(M, J, K, seed=90)
    phi = (jscan.transport_up if reverse else jscan.transport)(
        jnp.asarray(t), jnp.asarray(c))
    want = assoc._diag_affine_scan(
        jnp.broadcast_to(phi[:, :, None], G.shape), jnp.asarray(G),
        reverse=reverse)
    got = tscan.affine_prefix_plain(t64(phi)[None], t64(G)[None], reverse=reverse)
    assert_rel_close(got[0], want, RTOL)
