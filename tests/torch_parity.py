"""Shared helpers for the tests that hold celerite2_torch against the JAX
package (imported by tests/test_torch_*.py; not a test module)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import celerite2_torch
from celerite2_torch.ops.fused_loglik import loglik_fused
from celerite2_tpu import ops as jops
from celerite2_tpu import terms as jt
from celerite2_tpu.config import get_config, set_config

# The port's entry points place what is not yet a tensor on the card unless
# asked otherwise; the CPU tests ask for the CPU.
celerite2_torch.set_config(device="cpu")

COTANGENTS = ["bt", "bc", "ba", "bU", "bV", "by"]


def spec_from_jax(term):
    """The ``term_from_numpy`` description of a JAX term."""
    name = type(term).__name__
    if name == "TermSum":
        return {"type": name, "terms": [spec_from_jax(t) for t in term.terms]}
    if name == "TermProduct":
        return {"type": name,
                "terms": [spec_from_jax(term.term1), spec_from_jax(term.term2)]}
    if name == "TermDiff":
        return {"type": name, "term": spec_from_jax(term.term)}
    if name == "TermConvolution":
        return {"type": name, "term": spec_from_jax(term.term),
                "delta": np.asarray(term.delta)}
    return {
        "type": name,
        "params": {p: np.asarray(getattr(term, p)) for p in term._params},
    }


def t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def assert_scaled_close(got, want, atol, name=""):
    """|got - want| <= atol * max|want| (the JAX package's
    test_fused_slab._check_parity convention for cotangents)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = np.max(np.abs(want)) + 1e-300
    np.testing.assert_allclose(
        got / scale, want / scale, rtol=0, atol=atol, err_msg=name
    )


class jax_config:
    """Context manager: set the JAX package's config, restore it after."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __enter__(self):
        self.prior = get_config()
        set_config(**self.kwargs)

    def __exit__(self, *exc):
        set_config(**self.prior.__dict__)


def fused_system(N, J=2, seed=0, nonpd=False, sigma=1.3):
    """A celerite system ``(t, c, a, U, V, y)`` of width J as numpy
    arrays: J = 1 RealTerm, 2 SHOTerm, 3 RealTerm + SHOTerm, 4 an SHO
    mixture (underdamped + overdamped Q = 0.3).  ``nonpd`` makes the
    diagonal negative enough that the system is not positive definite."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, N))
    sho = jt.SHOTerm(sigma=sigma, rho=3.4, tau=2.9)
    kernel = {
        1: lambda: jt.RealTerm(a=sigma - 0.2, c=0.7),
        2: lambda: sho,
        3: lambda: jt.RealTerm(a=0.4, c=1.7) + sho,
        4: lambda: sho + jt.SHOTerm(sigma=0.6, rho=1.1, Q=0.3),
    }[J]()
    diag = np.full(N, -2.0 if nonpd else 0.04)
    c, a, U, V = kernel.get_celerite_matrices(t, diag)
    y = np.sin(t) + 0.2 * rng.normal(size=N)
    return tuple(np.asarray(x) for x in (t, c, a, U, V, y))


def ll_ref(t, c, a, U, V, y):
    """The JAX package's log-likelihood through ``ops.factor_solve``
    (tests/test_fused_slab.py's ``_ll_ref``)."""
    d, _, z = jops.factor_solve(t, c, a, U, V, y[:, None])
    ok = jnp.all(d > 0)
    safe_d = jnp.where(d > 0, d, jnp.ones_like(d))
    ll = -0.5 * (
        jnp.sum(jnp.log(safe_d))
        + jnp.sum(z[:, 0] ** 2 / safe_d)
        + t.shape[0] * np.log(2 * np.pi)
    )
    return jnp.where(ok, ll, -jnp.inf)


def jax_value_and_grads(fn, args):
    """Value and the six cotangents of ``fn`` under the JAX package's
    scan tier."""
    with jax_config(backend="scan", fused_slab="off"):
        jargs = tuple(jnp.asarray(x) for x in args)
        value = fn(*jargs)
        grads = jax.grad(fn, argnums=tuple(range(6)))(*jargs)
    return float(value), [np.asarray(g) for g in grads]


def torch_value_and_grads(args, block_len=None):
    """The port on one chain: (t, c, a, U, V, y) gain the chain axis."""
    t, *rest = (t64(x).requires_grad_(True) for x in args)
    batched = [x[None] for x in rest]
    ll = loglik_fused(t, *batched, block_len=block_len)
    grads = torch.autograd.grad(ll.sum(), [t, *rest])
    return ll[0].item(), [g.numpy() for g in grads]


def check_parity(got, want):
    """Value at rtol 1e-10 and each cotangent at scaled 1e-9
    (test_fused_slab._check_parity's tolerances)."""
    v0, g0 = got
    v1, g1 = want
    np.testing.assert_allclose(v0, v1, rtol=1e-10)
    for name, x0, x1 in zip(COTANGENTS, g0, g1):
        assert x0.shape == x1.shape, name
        assert_scaled_close(x0, x1, 1e-9, name)


# ------------------------------------------- systems of any width J <= 32

WIDTHS = [1, 2, 3, 5, 8, 16]


def wide_kernel(mod, J, sigma=1.3):
    """A kernel of width J from either package's term classes (``mod`` is
    ``celerite2_tpu.terms`` or ``celerite2_torch``): J // 2 SHOTerms (the
    second one overdamped) and, for odd J, a RealTerm."""
    parts = [
        mod.SHOTerm(sigma=sigma / (1 + i), rho=1.0 + 1.7 * i,
                    **({"Q": 0.3} if i == 1 else {"tau": 2.0 + i}))
        for i in range(J // 2)
    ]
    if J % 2:
        parts.append(mod.RealTerm(a=0.4 * sigma, c=0.7))
    return parts[0] if len(parts) == 1 else mod.TermSum(*parts)


def wide_system(N, J, K, seed=0, sigma=1.3):
    """``(t, c, a, U, V, Y)`` of one system of width J with K right-hand
    sides, as numpy arrays, built by the JAX package's terms."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, N))
    diag = rng.uniform(0.05, 0.2, N)
    c, a, U, V = wide_kernel(jt, J, sigma).get_celerite_matrices(t, diag)
    Y = rng.normal(size=(N, K))
    return tuple(np.asarray(x) for x in (t, c, a, U, V, Y))


def chains(arrays):
    """Float64 tensors with a leading chain axis of length 1."""
    return tuple(t64(x)[None] for x in arrays)


def assert_rel_close(got, want, rtol, name=""):
    """max|got - want| <= rtol * max|want|, shapes equal."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.max(np.abs(want)) + 1e-300
    assert np.max(np.abs(got - want)) <= rtol * scale, (
        name, np.max(np.abs(got - want)) / scale)


# -------------------------------- the fused loglik's K1 and K2, one by one


def fused_pass_inputs(args, block_len=None):
    """The inputs K1 and K2 receive when ``loglik_fused`` evaluates the
    value and gradient of one system ``(t, c, a, U, V, y)`` (numpy)."""
    from celerite2_torch.ops.fused_loglik import pass_inputs

    t, *rest = (t64(x) for x in args)
    return pass_inputs(t, *(x[None] for x in rest), block_len=block_len)


def check_kalman_states_against_factor(args, block_len=None, rtol=1e-10):
    """The plain K1's states ``(S, F)`` of one system through what the
    log-likelihood derives from them, d = a - u^T S u, W = (V - S u) / d
    and Z = y - u^T F, against the JAX package's ``ops.factor`` and
    ``ops.solve_lower``."""
    from celerite2_torch.ops.fused_loglik import kalman_fwd_plain

    L = 256 if block_len is None else block_len
    p, U, V, ainv, y = fused_pass_inputs(args, block_len)["kalman_fwd"]
    S, F = kalman_fwd_plain(p, U, V, ainv, y, L)
    t, c, a = (t64(x) for x in args[:3])
    Su = (S[0] @ U[0, ..., None])[..., 0]
    d = a - (U[0] * Su).sum(-1)
    W = (V[0] - Su) / d[:, None]
    Z = y[0] - (U[0] * F[0]).sum(-1)
    jd, jW = jops.factor(*(jnp.asarray(x) for x in args[:5]))
    jZ = jops.solve_lower(jnp.asarray(args[0]), jnp.asarray(args[1]),
                          jnp.asarray(args[3]), jW, jnp.asarray(args[5])[:, None])
    for name, got, want in (("d", d, jd), ("W", W, jW), ("Z", Z, jZ[:, 0])):
        assert_rel_close(got.numpy(), np.asarray(want), rtol, name)


def check_solve_rev_against_recursion(args, block_len=None, rtol=1e-10):
    """The plain K2's suffix states ``Rst`` of one system against the solve
    adjoint's row recursion in numpy: Rst_n = p_n (Rst_{n+1} - u_n (w_n .
    Rst_{n+1} + bZ_n)) from zero past the last row, u_0 = 0."""
    from celerite2_torch.ops.fused_loglik import solve_rev_plain

    L = 256 if block_len is None else block_len
    p, U, W, bz = fused_pass_inputs(args, block_len)["solve_rev"]
    got = solve_rev_plain(p, U, W, bz, L)[0].numpy()
    p, U, W, bz = (x[0].numpy() for x in (p, U, W, bz))
    want = np.empty_like(got)
    R = np.zeros(U.shape[1])
    for n in range(U.shape[0] - 1, -1, -1):
        u = U[n] if n else np.zeros_like(U[n])
        R = p[n] * (R - u * (W[n] @ R + bz[n]))
        want[n] = R
    assert_rel_close(got, want, rtol, "Rst")


def check_factor_adjoint_against_recursion(args, block_len=None, rtol=1e-10):
    """The plain factor adjoint's states ``MX`` of one system against its
    row recursion in numpy, for each plain route there is at its width
    (K3 at J <= 2; K4 and K5 at every J): from M = 0 past the last row,
    M_n = p_n (.) [M - u_n (x) bv - ba u_n (x) u_n] (.) p_n with bv =
    (M + M^T) w_n + bv0_n, ba = bdp_n - w_n^T M w_n and u_0 = 0; MX holds
    the state entering row n for n >= 1 and the state after row 0's step
    at row 0."""
    from celerite2_torch.ops.fused_loglik import factor_adjoint

    L = 256 if block_len is None else block_len
    inputs = fused_pass_inputs(args, block_len)
    fin = inputs["factor_rev"] if "factor_rev" in inputs else inputs["frev_maps"]
    p, U, W, bv0, bdp = (x[0].numpy() for x in fin)
    N, J = U.shape
    want = np.empty((N, J, J))
    M = np.zeros((J, J))
    for n in range(N - 1, -1, -1):
        u = U[n] if n else np.zeros(J)
        bv = (M + M.T) @ W[n] + bv0[n]
        ba = bdp[n] - W[n] @ M @ W[n]
        after = p[n][:, None] * (M - np.outer(u, bv) - ba * np.outer(u, u)) * p[n]
        want[n] = M if n else after
        M = after
    for structured in ((False, True) if J <= 2 else (True,)):
        got = factor_adjoint(*fin, L, structured=structured)[0].numpy()
        assert_rel_close(got, want, rtol, f"MX structured={structured}")
