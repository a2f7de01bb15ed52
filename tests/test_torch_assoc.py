"""The port's assoc tier (celerite2_torch.ops.assoc, ops/prefix_engine.py
and the routing of ops/dispatch.py) against the JAX package's assoc tier
(celerite2_tpu.ops.assoc), float64 on the CPU, on the same numpy inputs.

On the CPU the JAX assoc functions run its generic engine
(``lax.associative_scan``) and the port its plain doubling, the plain
versions of the prefix kernels of csrc/assoc_prefix.cu.  One case per
family also holds the port against the TPU kernel itself
(planes_engine._block_prefix_kernel in Pallas interpret mode).
Tolerances: the element algebra 1e-12, the prefixes 1e-10 and the forward
ops 1e-9 relative to each array's largest entry; the adjoints rtol 1e-8,
atol 1e-10 (tests/test_assoc_rev.py's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import celerite2_torch as ct
from celerite2_torch import ops as tops
from celerite2_torch.ops import assoc as tassoc
from celerite2_torch.ops import dispatch
from celerite2_torch.ops import elements as el
from celerite2_torch.ops import prefix_engine as pe
from celerite2_torch.ops import scan as tscan
from celerite2_tpu import ops as jops
from celerite2_tpu import terms as jt
from celerite2_tpu.ops import assoc as jassoc
from torch_parity import (
    assert_rel_close, assert_scaled_close, jax_config, t64, wide_system,
)

SWEEPS = ["solve_lower", "solve_upper", "matmul_lower", "matmul_upper"]
MODES = {"solve_lower": (True, False), "solve_upper": (True, True),
         "matmul_lower": (False, False), "matmul_upper": (False, True)}
ELEMENT_WIDTHS = [1, 2, 3, 4, 8]


def _jit(fn, **kw):
    """``fn`` (with keyword arguments ``kw``) compiled once by jax.jit: the
    JAX assoc functions run op by op are slow to dispatch on the CPU."""
    return jax.jit(functools.partial(fn, **kw))


class _backend:
    """Context manager: the port's ``backend``, restored after."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.prior = ct.get_config()
        ct.set_config(backend=self.name)

    def __exit__(self, *exc):
        ct.set_config(**self.prior.__dict__)


def _systems(N, J, K, C=2, seed=0):
    """C systems of width J as numpy arrays, the chains stacked first."""
    parts = [wide_system(N, J, K, seed=seed + i, sigma=1.3 - 0.2 * i)
             for i in range(C)]
    return tuple(np.stack(x) for x in zip(*parts))


def _elements(family, J, K=2, N=12, seed=0):
    """Well-conditioned elements of a family as numpy arrays (N, ...): the
    Riccati and Kalman elements of a real system, or contracting maps."""
    if family == "mat_affine":
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(N, J, J)) / (1.5 * np.sqrt(J))
        return A, rng.normal(size=(N, J, K))
    t, c, a, U, V, Y = wide_system(N + 1, J, K, seed=seed)
    p = tscan.transport(t64(t)[None], t64(c)[None])
    if family == "riccati":
        elems = pe.riccati_elements(p, t64(a)[None], t64(U)[None], t64(V)[None])
    else:
        elems = pe.kalman_elements(p, t64(a)[None], t64(U)[None], t64(V)[None],
                                   t64(Y)[None])
    return tuple(x[0, 1:].numpy() for x in elems)


# ------------------------------------------------------- element algebra

ALGEBRA = {
    "riccati_combine": ("riccati", tassoc.riccati_combine, jassoc._riccati_combine, None),
    "riccati_distribute_Q": ("riccati", tassoc.riccati_distribute_Q,
                             jassoc._riccati_distribute_Q, (1,)),
    "kalman_combine": ("kalman", tassoc.kalman_combine, jassoc._kalman_combine, None),
    "kalman_distribute": ("kalman", tassoc.kalman_distribute,
                          jassoc._kalman_distribute, (1, 3)),
    "mat_affine_combine": ("mat_affine", tassoc.mat_affine_combine,
                           jassoc._mat_affine_combine, None),
    "affine_distribute_b": ("mat_affine", tassoc.affine_distribute_b,
                            jassoc._affine_distribute_b, (1,)),
}


@pytest.mark.parametrize("J", ELEMENT_WIDTHS)
@pytest.mark.parametrize("name", list(ALGEBRA))
def test_element_algebra_matches_jax(name, J):
    """Each combine on pairs of elements against the JAX package's, 1e-12
    relative; a distribute variant on the leaves it keeps valid."""
    family, tfn, jfn, valid = ALGEBRA[name]
    elems = _elements(family, J, seed=J)
    e1 = tuple(x[:-1] for x in elems)
    e2 = tuple(x[1:] for x in elems)
    got = tfn(tuple(map(t64, e1)), tuple(map(t64, e2)))
    want = jfn(tuple(map(jnp.asarray, e1)), tuple(map(jnp.asarray, e2)))
    for i in valid or range(len(want)):
        assert_rel_close(got[i].numpy(), want[i], 1e-12, f"{name} leaf {i}")


def test_small_inv_is_the_clamped_inverse():
    """The assoc tier's small inverse is elements.inv_clamped, the JAX
    package's _small_inv at J = 1..8."""
    assert tassoc.small_inv is el.inv_clamped
    rng = np.random.default_rng(0)
    for J in (1, 2, 3, 4, 8):
        M = np.eye(J) + 0.3 * rng.normal(size=(5, J, J))
        assert_rel_close(tassoc.small_inv(t64(M)).numpy(),
                         jassoc._small_inv(jnp.asarray(M)), 1e-12, f"J={J}")


# ------------------------------------------------------ the plain prefixes

PREFIX = {
    "riccati": (el.riccati_combine, jassoc._riccati_combine),
    "kalman": (el.kalman_combine, jassoc._kalman_combine),
    "mat_affine": (el.affine_combine, jassoc._mat_affine_combine),
}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("J", [2, 4])
@pytest.mark.parametrize("family", list(PREFIX))
def test_plain_prefix_matches_associative_scan(family, J, reverse):
    """The plain doubling of each family against lax.associative_scan with
    the JAX package's combine, forward and reverse, N = 37, 1e-10."""
    tcomb, jcomb = PREFIX[family]
    elems = _elements(family, J, N=37, seed=3)
    want = jax.jit(lambda e: lax.associative_scan(jcomb, e, reverse=reverse))(
        tuple(map(jnp.asarray, elems)))
    tel = tuple(t64(x)[None] for x in elems)
    if reverse:
        tel = tuple(x.flip(1) for x in tel)
    got = pe._doubling(tcomb, tel)
    if reverse:
        got = tuple(x.flip(1) for x in got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g[0].numpy(), w, 1e-10, f"{family} leaf {i}")


def test_family_entry_points_match_their_leaves():
    """riccati_prefix, kalman_prefix and mat_affine_prefix on the CPU return
    the Q, (Q, b) and b leaves of the doubling of their elements."""
    t, c, a, U, V, Y = map(t64, _systems(40, 4, 2))
    p = tscan.transport(t, c)
    S = pe.riccati_prefix(p, a, U, V)
    S2, F = pe.kalman_prefix(p, a, U, V, Y)
    full = pe._doubling(el.kalman_combine, pe.kalman_elements(p, a, U, V, Y))
    assert torch.allclose(S, full[1], rtol=1e-12, atol=0)
    assert torch.allclose(S2, full[1], rtol=1e-12, atol=0)
    assert torch.allclose(F, full[3], rtol=1e-12, atol=0)
    A, b = (t64(x)[None] for x in _elements("mat_affine", 3, N=40))
    assert torch.equal(pe.mat_affine_prefix(A, b, reverse=True),
                       pe.mat_affine_prefix_plain(A, b, reverse=True))


# ---------------------------------------------- the prefix kernels' order

BLOCKED_L = 4  # rows a block: 32 blocks are one group of the CUDA kernels


def _stiff_system(J, N, nonpd):
    """One system of width J = 2, 4 or 8 with wide8's stiff term (the
    SHOTerm at Q = 0.5): alone at J = 2, beside wide8's first term at
    J = 4, wide8 at theta = log[1, 5, 3] at J = 8; t ~ U(0, N / 10).
    ``nonpd`` cuts row N - 2's diagonal to 5%, so that its pivot d is
    negative in one of the last rows (C7)."""
    rng = np.random.default_rng(J + N)
    t = np.sort(rng.uniform(0, N / 10, N))
    terms = [jt.SHOTerm(sigma=1.0, rho=5.0, tau=3.0)] + [
        jt.SHOTerm(sigma=0.5 + 0.2 * j, rho=5.0 * (1.7 + j), Q=0.3 + 0.1 * j)
        for j in range(3)]
    kernel = {2: terms[3], 4: terms[0] + terms[3], 8: jt.TermSum(*terms)}[J]
    c, a, U, V = kernel.get_celerite_matrices(t, np.full(N, 0.0625))
    a = np.array(a)
    if nonpd:
        a[N - 2] *= 0.05
    Y = rng.normal(size=(N, 1))
    return tuple(np.asarray(x) for x in (t, c, a, U, V, Y))


@functools.lru_cache(maxsize=None)
def _jax_factor_solve(J, N, nonpd):
    """The system and the JAX package's factor_solve_assoc of it."""
    sys_ = _stiff_system(J, N, nonpd)
    out = _jit(jassoc.factor_solve_assoc)(*map(jnp.asarray, sys_))
    return sys_, tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("nonpd", [False, True])
@pytest.mark.parametrize("N", [32 * BLOCKED_L - 1, 32 * BLOCKED_L, 32 * BLOCKED_L + 1])
@pytest.mark.parametrize("J", [2, 4, 8])
@pytest.mark.parametrize("family", ["riccati", "kalman"])
def test_kernel_order_matches_jax(monkeypatch, family, J, N, nonpd):
    """The Riccati and Kalman prefixes in the order of the CUDA kernels
    (pe.kalman_prefix_blocked: blocks of 4 rows, groups of 32 blocks; N at
    one group and a row either side) under the assoc tier's factor and
    factor_solve, against the JAX package's factor_solve_assoc (jitted,
    float64), 1e-9 relative (test_forward_ops_match_jax's tolerance)."""
    sys_, want = _jax_factor_solve(J, N, nonpd)
    if nonpd:
        assert want[0][N - 2] < 0 < want[0][:N - 2].min()
    monkeypatch.setattr(pe, "riccati_prefix", lambda p, a, U, V: (
        pe.kalman_prefix_blocked(p, a, U, V, block_len=BLOCKED_L)))
    monkeypatch.setattr(pe, "kalman_prefix", lambda p, a, U, V, Y: (
        pe.kalman_prefix_blocked(p, a, U, V, Y, block_len=BLOCKED_L)))
    args = tuple(t64(x)[None] for x in sys_)
    if family == "riccati":
        got, want = tassoc.factor_assoc(*args[:5]), [want[i] for i in (0, 1, 3)]
    else:
        got = tassoc.factor_solve_assoc(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g[0].numpy(), w, 1e-9, f"{family} output {i}")


@pytest.mark.parametrize("scan_threads", [2, 4])
@pytest.mark.parametrize("J", [2, 4])
@pytest.mark.parametrize("family", ["riccati", "kalman"])
def test_kernel_order_over_runs_of_groups_matches_jax(monkeypatch, family, J,
                                                      scan_threads):
    """The order of the J <= 4 kernels where their scan over the groups
    gives a thread a run of several groups (as the card's 128 threads do
    from 129 groups on): N = 129 in one-row blocks, five groups over 2 or
    4 threads, against the JAX package's factor_solve_assoc (jitted,
    float64), 1e-9 relative."""
    N = 129
    sys_, want = _jax_factor_solve(J, N, False)
    monkeypatch.setattr(pe, "riccati_prefix", lambda p, a, U, V: (
        pe.kalman_prefix_blocked(p, a, U, V, block_len=1,
                                 scan_threads=scan_threads)))
    monkeypatch.setattr(pe, "kalman_prefix", lambda p, a, U, V, Y: (
        pe.kalman_prefix_blocked(p, a, U, V, Y, block_len=1,
                                 scan_threads=scan_threads)))
    args = tuple(t64(x)[None] for x in sys_)
    if family == "riccati":
        got, want = tassoc.factor_assoc(*args[:5]), [want[i] for i in (0, 1, 3)]
    else:
        got = tassoc.factor_solve_assoc(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_rel_close(g[0].numpy(), w, 1e-9, f"{family} output {i}")


# ---------------------------------------------------------- forward ops

FORWARD = ["factor", "factor_solve"] + SWEEPS


def _forward(op, mod, t, c, a, U, V, Y, W):
    if op == "factor":
        return getattr(mod, "factor_assoc" if mod is not tscan else "factor_scan")(
            t, c, a, U, V)
    if op == "factor_solve":
        name = "factor_solve_assoc" if mod is not tscan else "factor_solve_scan"
        return getattr(mod, name)(t, c, a, U, V, Y)
    second = W if op.startswith("solve") else V
    return getattr(mod, f"{op}_{'scan' if mod is tscan else 'assoc'}")(
        t, c, U, second, Y)


@pytest.mark.parametrize("J", ELEMENT_WIDTHS)
@pytest.mark.parametrize("op", FORWARD)
def test_forward_ops_match_jax(op, J):
    """Every forward op of the port's assoc tier, values and caches, against
    the JAX package's assoc function per chain, 1e-9 relative, and against
    the port's scan tier; two chains, N = 17, 65 or 130, K = 1 or 3."""
    N = (17, 65, 130)[J % 3]
    K = 1 + 2 * (J % 2)
    sys_ = _systems(N, J, K, seed=10 * J)
    t, c, a, U, V, Y = map(t64, sys_)
    W = tscan.factor_scan(t, c, a, U, V)[1]
    got = _forward(op, tassoc, t, c, a, U, V, Y, W)
    scan_twin = _forward(op, tscan, t, c, a, U, V, Y, W)
    jax_op = jax.jit(functools.partial(_forward, op, jassoc))
    for k in range(2):
        jargs = [jnp.asarray(x[k]) for x in sys_] + [jnp.asarray(W[k].numpy())]
        want = jax_op(*jargs)
        for i, (g, w, s) in enumerate(zip(got, want, scan_twin)):
            assert_rel_close(g[k].numpy(), w, 1e-9, f"{op} output {i}")
            assert_rel_close(g[k].numpy(), s[k].numpy(), 1e-9, f"{op} vs scan {i}")


# ------------------------------------------------------------- adjoints


@pytest.mark.parametrize("J", [1, 3, 8])
@pytest.mark.parametrize("op", SWEEPS)
def test_sweep_rev_matches_jax(op, J):
    """sweep_rev_assoc in its four modes against the JAX package's, on the
    scan tier's forward and random cotangents, N = 65, K = 2."""
    is_solve, upper = MODES[op]
    t, c, a, U, V, Y = wide_system(65, J, 2, seed=J)
    W = np.asarray(_jit(jops.factor)(*map(jnp.asarray, (t, c, a, U, V)))[1])
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    Z, F = _jit(getattr(jassoc, f"{op}_assoc"))(
        *map(jnp.asarray, (t, c, U, second, Y)))
    bZ = np.random.default_rng(J).normal(size=Y.shape)
    args = (t, c, A, B, Y, np.asarray(Z), np.asarray(F), bZ)
    want = _jit(jassoc.sweep_rev_assoc, is_solve=is_solve, upper=upper)(
        *map(jnp.asarray, args))
    got = tassoc.sweep_rev_assoc(*(t64(x)[None] for x in args),
                                 is_solve=is_solve, upper=upper)
    for name, g, w in zip(("bt", "bc", "bA", "bB", "bY"), got, want):
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-8, atol=1e-10,
                                   err_msg=f"{op} {name}")


@pytest.mark.parametrize("J", [1, 2, 3, 4, 8])
def test_factor_rev_matches_jax(J):
    """factor_rev_assoc (dense per-step maps at J <= 2, the structured
    phases A, B, C above) against the JAX package's, N = 130."""
    t, c, a, U, V, _ = wide_system(130, J, 1, seed=J)
    d, W, S = map(np.asarray, _jit(jassoc.factor_assoc)(
        *map(jnp.asarray, (t, c, a, U, V))))
    rng = np.random.default_rng(J)
    args = (t, c, a, U, V, d, W, S, rng.normal(size=d.shape), rng.normal(size=W.shape))
    want = _jit(jassoc.factor_rev_assoc)(*map(jnp.asarray, args))
    got = tassoc.factor_rev_assoc(*(t64(x)[None] for x in args))
    for name, g, w in zip(("bt", "bc", "ba", "bU", "bV"), got, want):
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-8, atol=1e-10,
                                   err_msg=f"J={J} {name}")


@pytest.mark.parametrize("J, block_len", [(4, 32), (8, None)])
def test_structured_factor_rev_over_several_blocks(monkeypatch, J, block_len):
    """Phases A, B, C over several blocks with a ragged last one (the fused
    path's K4, K5 in blocks of 32 rows at J = 4; the PyTorch loops in blocks
    of 32 steps over 129 at J = 8), 4 chains, against the scan tier's
    adjoint."""
    from celerite2_torch.ops import fused_loglik

    if block_len:
        monkeypatch.setattr(fused_loglik, "default_block_len", lambda N: block_len)
    t, c, a, U, V, _ = map(t64, _systems(130, J, 1, C=4, seed=3))
    d, W, S = tscan.factor_scan(t, c, a, U, V)
    rng = np.random.default_rng(4)
    bd, bW = t64(rng.normal(size=d.shape)), t64(rng.normal(size=W.shape))
    assert tassoc.frev_block_len(4, 129, J) == 32
    got = tassoc.factor_rev_assoc(t, c, a, U, V, d, W, S, bd, bW)
    want = tscan.factor_rev_scan(t, c, a, U, V, d, W, S, bd, bW)
    for g, w in zip(got, want):
        assert_rel_close(g.numpy(), w.numpy(), 1e-9)


# ------------------------------------------- through ops, backend="assoc"


def _op_args(op, t, c, a, U, V, Y, W):
    if op == "factor":
        return (t, c, a, U, V)
    if op == "factor_solve":
        return (t, c, a, U, V, Y)
    return (t, c, U, W if op.startswith("solve") else V, Y)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("J", [3, 5, 8])
@pytest.mark.parametrize("op", FORWARD)
def test_ops_on_the_assoc_tier_match_jax_vjp(op, J):
    """Every cotangent of every op run with backend="assoc" against jax.vjp
    of the JAX package's op on its assoc tier, scaled 1e-9 (N = 41, K = 2,
    widths the bucket pads: 3 -> 4, 5 -> 8)."""
    sys_ = wide_system(41, J, 2, seed=300 + J)
    W = np.asarray(_jit(jops.factor)(*map(jnp.asarray, sys_[:5]))[1])
    args = _op_args(op, *sys_, W)
    rng = np.random.default_rng(J)
    shapes = {"factor": [(41,), (41, J)],
              "factor_solve": [(41,), (41, J), (41, 2)]}.get(op, [(41, 2)])
    cots = tuple(jnp.asarray(rng.normal(size=s)) for s in shapes)

    def value_and_vjp(*a):
        out, vjp = jax.vjp(getattr(jops, op), *a)
        return out, vjp(cots if isinstance(out, tuple) else cots[0])

    with jax_config(backend="assoc"):
        out, want = jax.jit(value_and_vjp)(*map(jnp.asarray, args))
    targs = [t64(x).requires_grad_(True) for x in args]
    with _backend("assoc"):
        tout = _as_tuple(getattr(tops, op)(*targs))
        got = torch.autograd.grad(tout, targs, [t64(x) for x in cots])
    for g, w in zip(tout, _as_tuple(out)):
        assert_rel_close(g.detach().numpy(), w, 1e-9, op)
    for g, w, name in zip(got, want, "tcaUVY" if op.startswith("factor") else "tcABY"):
        assert g.shape == w.shape, name
        assert_scaled_close(g, w, 1e-9, f"{op} b{name}")


def _wide8(mod, theta):
    """Four SHOTerms as a function of theta = log[sigma, rho, tau], from
    either package's term classes."""
    exp = torch.exp if mod is ct else jnp.exp
    s, r, tau = exp(theta[0]), exp(theta[1]), exp(theta[2])
    k = mod.SHOTerm(sigma=s, rho=r, tau=tau)
    for j in range(3):
        k = k + mod.SHOTerm(sigma=s * (0.5 + 0.2 * j), rho=r * (1.7 + j),
                            Q=0.3 + 0.1 * j)
    return k


@pytest.mark.parametrize("N", [65, 130])
def test_gp_loglik_at_j8_on_the_assoc_tier_matches_jax(N):
    """gp_loglik value (1e-10) and theta-gradient (scaled 1e-9) at J = 8
    with backend="assoc" against the JAX package's on its assoc tier."""
    from celerite2_tpu import gp as jgp
    from celerite2_tpu import terms as jt

    rng = np.random.default_rng(N)
    t = np.sort(rng.uniform(0, 10, N))
    y = np.sin(t) + 0.2 * rng.normal(size=N)
    theta0 = np.log([1.0, 2.0, 3.0])

    def jax_ll(th):
        return jgp.gp_loglik(_wide8(jt, th), jnp.asarray(t), jnp.asarray(y),
                             yerr=0.3)

    with jax_config(backend="assoc", fused_slab="off"):
        v0, g0 = jax.jit(jax.value_and_grad(jax_ll))(jnp.asarray(theta0))
    v0, g0 = float(v0), np.asarray(g0)
    th = t64(theta0).requires_grad_(True)
    with _backend("assoc"):
        ll = ct.gp_loglik(_wide8(ct, th), t64(t), t64(y), yerr=0.3)
        (g,) = torch.autograd.grad(ll, th)
    np.testing.assert_allclose(ll.item(), v0, rtol=1e-10)
    assert_scaled_close(g.numpy(), g0, 1e-9, "theta")


@pytest.mark.parametrize("J", [2, 8])
def test_nonpd_on_the_assoc_tier_is_quiet(J):
    """A system that is not positive definite on the assoc tier: gp_loglik
    is -inf with zero gradients, and GaussianProcess.compute raises unless
    quiet."""
    rng = np.random.default_rng(J)
    t = t64(np.sort(rng.uniform(0, 10, 200)))
    y = torch.sin(t)
    theta = t64(np.log([1.0, 2.0, 3.0])).requires_grad_(True)
    with _backend("assoc"):
        kernel = _wide8(ct, theta) if J == 8 else ct.SHOTerm(
            sigma=theta[0].exp(), rho=theta[1].exp(), tau=theta[2].exp())
        ll = ct.gp_loglik(kernel, t, y, diag=-5.0)
        (g,) = torch.autograd.grad(ll, theta)
        with pytest.raises(ct.LinAlgError):
            ct.GaussianProcess(kernel, t, diag=-5.0)
    assert ll.item() == -np.inf and torch.all(g == 0)


# ------------------------------------------------- against the TPU kernel


@pytest.fixture
def planes_on(monkeypatch):
    from celerite2_tpu.ops import planes_engine

    # shrink the doubling leaf so N = 17 runs the Pallas kernel
    monkeypatch.setattr(planes_engine, "_LEAF", 16)
    with jax_config(planes="on"):
        yield


def test_riccati_family_matches_the_tpu_kernel(planes_on):
    """The port's factor on the assoc tier (the Riccati prefix) against the
    JAX package's factor_assoc through planes_engine._block_prefix_kernel in
    interpret mode, N = 17, J = 2, 1e-9."""
    sys_ = wide_system(17, 2, 1, seed=7)
    want = _jit(jassoc.factor_assoc)(*map(jnp.asarray, sys_[:5]))
    got = tassoc.factor_assoc(*(t64(x)[None] for x in sys_[:5]))
    for g, w in zip(got, want):
        assert_rel_close(g[0].numpy(), w, 1e-9)


def test_mat_affine_family_matches_the_tpu_kernel(planes_on):
    """The port's lower solve on the assoc tier (the matrix-affine prefix)
    against the JAX package's solve_lower_assoc through the Pallas kernel
    in interpret mode, N = 17, J = 2, 1e-9."""
    t, c, a, U, V, Y = wide_system(17, 2, 1, seed=8)
    with jax_config(planes="off"):
        W = np.asarray(_jit(jassoc.factor_assoc)(
            *map(jnp.asarray, (t, c, a, U, V)))[1])
    want = _jit(jassoc.solve_lower_assoc)(*map(jnp.asarray, (t, c, U, W, Y)))
    got = tassoc.solve_lower_assoc(*(t64(x)[None] for x in (t, c, U, W, Y)))
    for g, w in zip(got, want):
        assert_rel_close(g[0].numpy(), w, 1e-9)


# ------------------------------------------------------------ routing


def test_auto_keeps_cpu_tensors_on_the_scan_tier(monkeypatch):
    """"auto" sends CPU tensors to the scan tier, whatever the size and the
    threshold; on CUDA it follows ASSOC_MIN_ROWS or assoc_threshold."""
    cpu = torch.device("cpu")
    assert dispatch.backend(cpu, 1, 10**6, 8, torch.float64) == "scan"
    with _backend("auto"):
        ct.set_config(assoc_threshold=10)
        assert dispatch.backend(cpu, 1, 10**6, 8, torch.float64) == "scan"
        assert dispatch.backend("cuda", 1, 100, 8, torch.float64) == "assoc"
        assert dispatch.backend("cuda", 1, 5, 8, torch.float64) == "scan"
        ct.set_config(assoc_threshold=None)
        monkeypatch.setattr(dispatch, "ASSOC_MIN_ROWS",
                            {(torch.float64, 8, False): 1000})
        assert dispatch.backend("cuda", 1, 1000, 5, torch.float64) == "assoc"
        assert dispatch.backend("cuda", 1, 999, 8, torch.float64) == "scan"
        assert dispatch.backend("cuda", 4, 10**5, 8, torch.float64) == "scan"
    t, c, a, U, V, _ = map(t64, wide_system(40, 3, 1))
    assert dispatch.tier(U, 1, 40, 3) is tscan


def test_forcing_assoc_on_the_cpu_runs_the_plain_prefixes(monkeypatch):
    """backend="assoc" on CPU tensors runs ops.assoc through the plain
    doublings (no kernel), and the scan tier's loops not at all."""
    calls = []
    for name in ("riccati_prefix_plain", "kalman_prefix_plain",
                 "mat_affine_prefix_plain"):
        def spy(*args, _fn=getattr(pe, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(pe, name, spy)
    for name in ("factor_fwd_plain", "sweep_fwd_plain", "factor_solve_plain"):
        monkeypatch.setattr(tscan, name, lambda *a, **k: pytest.fail("scan tier"))
    t, c, a, U, V, Y = map(t64, wide_system(40, 3, 1))
    with _backend("assoc"):
        assert dispatch.tier(U, 1, 40, 3) is tassoc
        d, W = tops.factor(t, c, a, U, V)
        tops.solve_lower(t, c, U, W, Y)
        tops.factor_solve(t, c, a, U, V, Y)
    assert calls == ["riccati_prefix_plain", "mat_affine_prefix_plain",
                     "kalman_prefix_plain"]


@pytest.mark.parametrize("J", [8, 9, 16, 32])
def test_float32_at_j16_never_takes_the_assoc_tier(J):
    """Float32 from the J = 8 bucket on stays on the scan tier under
    "auto", whatever the threshold (both packages' float32 assoc tier
    returns -inf at J = 8: the test below; at J = 16 the JAX one's does at
    N = 1e5), while float64 takes the assoc tier."""
    with _backend("auto"):
        ct.set_config(assoc_threshold=2)
        assert dispatch.backend("cuda", 1, 10**5, J, torch.float32) == "scan"
        assert dispatch.backend("cuda", 1, 10**5, J, torch.float64) == "assoc"
    with pytest.raises(ValueError, match="backend"):
        ct.set_config(backend="pallas")


def test_float32_assoc_tier_at_j8_is_quiet_in_both_packages():
    """Float32 at J = 8 (wide8 at theta = log[1, 5, 3] on the benchmark's
    data, seed 42, N = 3000): the assoc tier of both packages returns -inf,
    the port's with zero gradients, while both scan tiers are finite.  The
    JAX side runs jitted with x64 off (with it on, the JAX package takes
    these float32 inputs to float64)."""
    from celerite2_tpu.gp import gp_loglik as jax_gp_loglik
    from celerite2_tpu import terms as jt

    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, 3000))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=3000)
    theta = np.log([1.0, 5.0, 3.0])
    for tier in ("scan", "assoc"):
        with jax_config(backend=tier), jax.enable_x64(False):
            fn = jax.jit(jax.value_and_grad(lambda th, t, y: jax_gp_loglik(
                _wide8(jt, th), t, y, yerr=0.25)))
            jv, jg = fn(*(jnp.asarray(x, jnp.float32) for x in (theta, t, y)))
        assert jv.dtype == jnp.float32
        with _backend(tier):
            th = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
            ll = ct.gp_loglik(_wide8(ct, th),
                              torch.tensor(t, dtype=torch.float32),
                              torch.tensor(y, dtype=torch.float32), yerr=0.25)
            (g,) = torch.autograd.grad(ll, th)
        if tier == "scan":
            assert np.isfinite(float(jv)) and np.all(np.isfinite(jg))
            assert torch.isfinite(ll) and torch.isfinite(g).all()
            assert abs(ll.item() - float(jv)) < 1e-3 * abs(float(jv))
        else:
            assert float(jv) == -np.inf
            assert ll.item() == -np.inf and torch.all(g == 0)


def test_float32_quiet_failure_has_zero_gradients():
    """gp_loglik at J > 4 masks a chain that is not positive definite out of
    its sums before they are taken: wide8 at chip_smoke.py's C5 theta of
    chain 48, float32 on the assoc tier at N = 3e4, gives -inf with zero
    gradients, where z^2 / d overflows float32 (the JAX package's gradient
    is NaN there: ROADMAP D4)."""
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, 30_000))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=30_000)
    noise = np.random.default_rng(17).normal(size=(64, 3))[[0, 48]]
    theta = torch.tensor(np.log([1.0, 5.0, 3.0]) + 0.1 * noise,
                         dtype=torch.float32, requires_grad=True)
    with _backend("assoc"):
        ll = ct.gp_loglik(_wide8(ct, theta.T),
                          torch.tensor(t, dtype=torch.float32),
                          torch.tensor(y, dtype=torch.float32), yerr=0.25)
        (g,) = torch.autograd.grad(ll.sum(), theta)
    assert torch.all(ll == -np.inf) and torch.all(g == 0)
