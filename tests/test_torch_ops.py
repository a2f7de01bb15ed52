"""The port's public ops (celerite2_torch.ops) against the JAX package's
(celerite2_tpu.ops, scan tier), float64 on the CPU: values to 1e-10
relative to each array's largest entry, the cotangents of their hand-derived
adjoints against jax.vjp to 1e-9; and their argument contracts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch import ops as tops
from celerite2_torch.config import J_BUCKETS, pad_width
from celerite2_torch.models import term_from_numpy
from celerite2_torch.ops import api as tapi
from celerite2_torch.ops.spec import OPS, validate_call
from celerite2_torch.utils.misc import as_tensor
from celerite2_tpu import ops as jops
from celerite2_tpu import terms as jt
from torch_parity import (
    WIDTHS, assert_rel_close, assert_scaled_close, jax_config, t64, wide_kernel,
    wide_system,
)

RTOL = 1e-10
N = 101
SWEEPS = ["solve_lower", "solve_upper", "matmul_lower", "matmul_upper"]


def _jax(fn, *args):
    with jax_config(backend="scan"):
        return fn(*map(jnp.asarray, args))


@pytest.mark.parametrize("J", WIDTHS)
def test_factor_matches_jax(J):
    t, c, a, U, V, _ = wide_system(N, J, 1, seed=J)
    jd, jW = _jax(jops.factor, t, c, a, U, V)
    d, W = tops.factor(*map(t64, (t, c, a, U, V)))
    assert W.shape == (N, J)  # sliced back from the bucket
    assert_rel_close(d, jd, RTOL, "d")
    assert_rel_close(W, jW, RTOL, "W")


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("J", WIDTHS)
@pytest.mark.parametrize("op", SWEEPS)
def test_sweeps_match_jax(op, J, K):
    t, c, a, U, V, Y = wide_system(N, J, K, seed=10 + J)
    _, W = _jax(jops.factor, t, c, a, U, V)
    second = np.asarray(W) if op.startswith("solve") else V
    want = _jax(getattr(jops, op), t, c, U, second, Y)
    got = getattr(tops, op)(*map(t64, (t, c, U, second, Y)))
    assert_rel_close(got, want, RTOL, op)


@pytest.mark.parametrize("J", [3, 8])
def test_chain_axis_matches_a_loop(J):
    """Every argument with a leading chain axis: C systems in one call."""
    systems = [wide_system(N, J, 2, seed=70 + k, sigma=1.0 + 0.2 * k)
               for k in range(3)]
    t, c, a, U, V, Y = (torch.stack([t64(s[i]) for s in systems])
                        for i in range(6))
    d, W = tops.factor(t, c, a, U, V)
    assert d.shape == (3, N) and W.shape == (3, N, J)
    z = {op: getattr(tops, op)(t, c, U, W if op.startswith("solve") else V, Y)
         for op in SWEEPS}
    for k in range(3):
        dk, Wk = tops.factor(t[k], c[k], a[k], U[k], V[k])
        assert_rel_close(d[k], dk, 1e-14)
        assert_rel_close(W[k], Wk, 1e-14)
        for op in SWEEPS:
            zk = getattr(tops, op)(
                t[k], c[k], U[k], Wk if op.startswith("solve") else V[k], Y[k])
            assert_rel_close(z[op][k], zk, 1e-14, op)


@pytest.mark.parametrize("J", [1, 3, 8, 16])
@pytest.mark.parametrize("name", ["general_matmul_lower", "general_matmul_upper"])
def test_general_matmul_matches_jax(name, J):
    """Rectangular products between two sorted time axes, with target
    points before, between, on and after the source points."""
    rng = np.random.default_rng(J)
    t2 = np.sort(rng.uniform(0, 10, 75))
    t1 = np.sort(np.concatenate([rng.uniform(-2, 12, 57), t2[[0, 30, 74]]]))
    kernel = wide_kernel(jt, J)
    c, _, U2, V2 = (np.asarray(x) for x in
                    kernel.get_celerite_matrices(t2, np.zeros_like(t2)))
    _, _, U1, V1 = (np.asarray(x) for x in
                    kernel.get_celerite_matrices(t1, np.zeros_like(t1)))
    Y = rng.normal(size=(75, 3))
    args = ((t1, t2, c, U1, V2, Y) if name.endswith("lower")
            else (t1, t2, c, V1, U2, Y))
    want = _jax(getattr(jops, name), *args)
    got = getattr(tops, name)(*map(t64, args))
    assert_rel_close(got, want, RTOL, name)
    # C = 2 systems at once
    both = getattr(tops, name)(*(torch.stack([t64(x), t64(x)]) for x in args))
    assert_rel_close(both[1], want, RTOL, name + " chains")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M", [1, 2, 37, 64])
def test_transported_cumulative_matches_a_loop(M, reverse):
    """The affine prefix (on the CPU, the doubling of the diagonal-affine
    combine) against the sequential recurrence F_m = phi_m F_prev + G_m."""
    rng = np.random.default_rng(M)
    phi = t64(rng.uniform(0.1, 1.0, (M, 3)))
    G = t64(rng.normal(size=(M, 3, 2)))
    F = torch.zeros(3, 2, dtype=torch.float64)
    want = [None] * M
    for m in (range(M - 1, -1, -1) if reverse else range(M)):
        F = phi[m][:, None] * F + G[m]
        want[m] = F
    got = tapi._transported_cumulative(phi, G, reverse=reverse)
    assert_rel_close(got, torch.stack(want), 1e-13)


@pytest.mark.parametrize("name", ["general_matmul_lower", "general_matmul_upper"])
def test_general_matmul_gradient_matches_jax(name):
    """The rectangular products are differentiable (the affine prefix
    carries its adjoint): gradients with respect to c, U, V, Y against
    jax.grad of the JAX package's op on its scan tier, scaled 1e-9."""
    import jax

    rng = np.random.default_rng(11)
    t2 = np.sort(rng.uniform(0, 10, 41))
    t1 = np.sort(rng.uniform(-1, 11, 29))
    args = (t1, t2, rng.uniform(0.1, 2.0, 3), rng.normal(size=(29, 3)),
            rng.normal(size=(41, 3)), rng.normal(size=(41, 2)))
    weight = rng.normal(size=(29, 2))
    with jax_config(backend="scan"):
        want = jax.grad(
            lambda *a: jnp.sum(jnp.asarray(weight) * getattr(jops, name)(*a)),
            argnums=(2, 3, 4, 5))(*map(jnp.asarray, args))
    targs = [t64(x) for x in args]
    for x in targs[2:]:
        x.requires_grad_(True)
    z = getattr(tops, name)(*targs)
    got = torch.autograd.grad((t64(weight) * z).sum(), targs[2:])
    for g, w, label in zip(got, want, "cUVY"):
        assert_rel_close(g, w, 1e-9, label)


@pytest.mark.parametrize("reverse", [False, True])
def test_transported_cumulative_gradient_matches_autograd(reverse):
    """The hand-derived adjoint of the affine prefix against autograd
    through the row-by-row recurrence, with a chain axis."""
    rng = np.random.default_rng(5)
    M = 23
    phi = t64(rng.uniform(0.1, 1.0, (2, M, 3))).requires_grad_(True)
    G = t64(rng.normal(size=(2, M, 3, 2))).requires_grad_(True)
    weight = t64(rng.normal(size=(2, M, 3, 2)))
    F, rows = torch.zeros(2, 3, 2, dtype=torch.float64), [None] * M
    for m in (range(M - 1, -1, -1) if reverse else range(M)):
        F = phi[:, m, :, None] * F + G[:, m]
        rows[m] = F
    want = torch.autograd.grad((weight * torch.stack(rows, 1)).sum(), (phi, G))
    got = torch.autograd.grad(
        (weight * tapi._transported_cumulative(phi, G, reverse=reverse)).sum(),
        (phi, G))
    assert_rel_close(got[0], want[0], 1e-12, "bphi")
    assert_rel_close(got[1], want[1], 1e-12, "bG")


@pytest.mark.parametrize("J", [2, 5])
def test_to_dense_matches_jax_and_the_term(J):
    t, c, a, U, V, _ = wide_system(40, J, 1, seed=J)
    want = _jax(jops.to_dense, t, c, a, U, V)
    got = tops.to_dense(*map(t64, (t, c, a, U, V)))
    assert_rel_close(got, want, 1e-12)
    # the same matrix from the port's term, and its O(N) product
    rng = np.random.default_rng(0)
    diag = rng.uniform(0.05, 0.2, 40)
    kernel = wide_kernel(ct, J)
    K = kernel.to_dense(t64(t), t64(diag))
    dense = tops.to_dense(t64(t), *kernel.get_celerite_matrices(t64(t), t64(diag)))
    assert_rel_close(dense, K, 1e-12)
    y = rng.normal(size=(40, 3))
    jdot = wide_kernel(jt, J).dot(t, diag, y)
    assert_rel_close(kernel.dot(t64(t), t64(diag), t64(y)), jdot, RTOL)
    assert_rel_close(kernel.dot(t64(t), t64(diag), t64(y[:, 0])), K @ t64(y[:, 0]),
                     RTOL)
    with pytest.raises(ValueError, match="dimension mismatch"):
        kernel.dot(t64(t), t64(diag), t64(y[:-1]))


def test_get_value_on_a_lag_matrix_matches_jax():
    tau = np.random.default_rng(1).uniform(-5, 5, (7, 9))
    for J in (3, 8):
        assert_rel_close(wide_kernel(ct, J).get_value(t64(tau)),
                         wide_kernel(jt, J).get_value(tau), 1e-12)


def _op_args(op, t, c, a, U, V, Y, W):
    """The arguments of ``op``: the solves take the factor's W, the
    matmuls V."""
    if op == "factor":
        return (t, c, a, U, V)
    if op == "factor_solve":
        return (t, c, a, U, V, Y)
    return (t, c, U, W if op.startswith("solve") else V, Y)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("J", [3, 5, 31])
@pytest.mark.parametrize("op", ["factor", "factor_solve"] + SWEEPS)
def test_backward_matches_jax_vjp(op, J):
    """Every cotangent of the op (five, six for factor_solve) against
    jax.vjp of the JAX package's op on its scan tier, at widths that the
    bucket pads (3 -> 4, 5 -> 8, 31 -> 32), scaled 1e-9."""
    import jax

    sys_ = wide_system(41, J, 2, seed=200 + J)
    W = np.asarray(_jax(jops.factor, *sys_[:5])[1])
    args = _op_args(op, *sys_, W)
    rng = np.random.default_rng(J)
    with jax_config(backend="scan"):
        out, vjp = jax.vjp(getattr(jops, op), *map(jnp.asarray, args))
        cots = tuple(jnp.asarray(rng.normal(size=o.shape)) for o in _as_tuple(out))
        want = vjp(cots if isinstance(out, tuple) else cots[0])
    targs = [t64(x).requires_grad_(True) for x in args]
    got = torch.autograd.grad(_as_tuple(getattr(tops, op)(*targs)), targs,
                              [t64(x) for x in cots])
    assert len(got) == (6 if op == "factor_solve" else 5)
    for g, w, name in zip(got, want, "tcaUVY" if op.startswith("factor") else "tcABY"):
        assert g.shape == w.shape, name
        assert_scaled_close(g, w, 1e-9, f"{op} b{name}")


@pytest.mark.parametrize("op", ["factor", "factor_solve"] + SWEEPS)
def test_gradcheck(op):
    """torch.autograd.gradcheck of the hand adjoint against finite
    differences, float64, N = 9, J = 3 (bucketed to 4), K = 2."""
    t, c, a, U, V, Y = map(t64, wide_system(9, 3, 2, seed=5))
    W = tops.factor(t, c, a, U, V)[1]
    args = [x.requires_grad_(True) for x in _op_args(op, t, c, a, U, V, Y, W)]
    assert torch.autograd.gradcheck(getattr(tops, op), args, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_gradients_with_a_chain_axis_match_a_loop():
    """C = 3 systems in one call give, chain by chain, the gradients of
    each system alone."""
    systems = [wide_system(31, 5, 2, seed=80 + k, sigma=1.0 + 0.2 * k)
               for k in range(3)]
    stacked = [torch.stack([t64(s[i]) for s in systems]).requires_grad_(True)
               for i in range(6)]

    def loss(t, c, a, U, V, Y):
        d, W, Z = tops.factor_solve(t, c, a, U, V, Y)
        Zu = tops.solve_upper(t, c, U, W, Z)
        Zm = tops.matmul_lower(t, c, U, V, Y)
        return (d.sum() + (W * W).sum() + (Zu * Zu).sum() + (Zm * Y).sum())

    got = torch.autograd.grad(loss(*stacked), stacked)
    for k in range(3):
        one = [t64(x).requires_grad_(True) for x in systems[k]]
        want = torch.autograd.grad(loss(*one), one)
        for g, w in zip(got, want):
            assert_rel_close(g[k], w, 1e-13)


def test_no_gradient_is_no_error(monkeypatch):
    """Without anything that requires a gradient, or under
    torch.no_grad(), the ops are plain forward functions and ask the
    recursions for no cache; with a gradient to come they keep it."""
    t, c, a, U, V, Y = map(t64, wide_system(31, 3, 1))
    d, W = tops.factor(t, c, a, U, V)
    assert not d.requires_grad and not W.requires_grad
    assert not tops.solve_lower(t, c, U, W, Y).requires_grad

    from celerite2_torch.ops import scan

    asked = []
    for name in ("factor_fwd", "sweep_fwd", "factor_solve"):
        def spy(*args, _fn=getattr(scan, name), **kw):
            asked.append(kw["want_cache"])
            return _fn(*args, **kw)
        monkeypatch.setattr(scan, name, spy)
    U.requires_grad_(True)
    with torch.no_grad():
        tops.factor(t, c, a, U, V)
        tops.solve_upper(t, c, U, W, Y)
        tops.factor_solve(t, c, a, U, V, Y)
    tops.factor(t, c, a, U.detach(), V)
    assert asked == [False] * 4
    tops.factor(t, c, a, U, V)
    tops.matmul_upper(t, c, U, V, Y)
    tops.factor_solve(t, c, a, U, V, Y)
    assert asked[4:] == [True] * 3


def test_zero_and_missing_cotangents():
    """A cotangent that is zero (an output the loss does not use) gives
    exactly the gradient of the outputs that are used."""
    t, c, a, U, V, Y = (t64(x).requires_grad_(True) for x in wide_system(31, 5, 1))
    d, W, Z = tops.factor_solve(t, c, a, U, V, Y)
    only_d = torch.autograd.grad(d.sum(), (a, U, V), retain_graph=True)
    d2, _ = tops.factor(t, c, a, U, V)
    for g, w in zip(only_d, torch.autograd.grad(d2.sum(), (a, U, V))):
        assert_rel_close(g, w, 1e-13)
    (gY,) = torch.autograd.grad(Z.sum(), Y)
    assert torch.isfinite(gY).all()


def test_bucketing():
    assert [pad_width(J) for J in (1, 2, 3, 4, 5, 8, 9, 16, 17, 32)] == [
        1, 2, 4, 4, 8, 8, 16, 16, 32, 32]
    assert set(map(pad_width, range(1, 33))) == set(J_BUCKETS)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        pad_width(33)
    c = torch.full((2, 5), 0.3, dtype=torch.float64)
    U = torch.ones(2, 7, 5, dtype=torch.float64)
    c_p, (U_p,), J = tapi._bucketed(c, U)
    assert J == 5 and c_p.shape == (2, 8) and U_p.shape == (2, 7, 8)
    assert torch.all(c_p[:, 5:] == 1) and torch.all(U_p[..., 5:] == 0)
    same_c, (same_U,), _ = tapi._bucketed(c[:, :4], U[..., :4])
    assert same_c.shape == (2, 4) and same_U.shape == (2, 7, 4)


def test_validate_call_contracts():
    t, c, a, U, V, Y = map(t64, wide_system(20, 3, 2))
    assert validate_call("factor", t, c, a, U, V) == {"N": 20, "J": 3}
    assert validate_call("solve_lower", t[None], c[None], U[None], V[None],
                         Y[None]) == {"C": 1, "N": 20, "J": 3, "K": 2}
    assert set(OPS) == {"factor", "factor_solve", "solve_lower", "solve_upper",
                        "matmul_lower",
                        "matmul_upper", "general_matmul_lower",
                        "general_matmul_upper", "to_dense"}
    with pytest.raises(ValueError, match="expects 5 arguments"):
        validate_call("factor", t, c, a, U)
    with pytest.raises(ValueError, match="conflicts"):
        tops.factor(t, c, a[:-1], U, V)
    with pytest.raises(ValueError, match="expected rank"):
        tops.solve_lower(t, c, U, V, Y[:, 0])
    with pytest.raises(ValueError, match="expected rank"):
        tops.factor(t[None], c, a, U, V)  # the chain axis on one argument only
    with pytest.raises(ValueError, match="torch.float32"):
        tops.matmul_lower(t, c, U, V.float(), Y)
    with pytest.raises(ValueError, match="floating-point"):
        tops.to_dense(t, c, a, U, np.asarray(V))


# ------------------------------------------------- the default device


def test_as_tensor_places_non_tensors_on_the_default_device():
    """Numbers and numpy arrays go to Config.device (here "meta", a device
    every build of PyTorch has); tensors keep theirs; device= and like=
    override the default."""
    prior = ct.get_config()
    ct.set_config(device="meta")
    try:
        assert as_tensor(1.5).device.type == "meta"
        assert as_tensor(np.arange(3.0)).device.type == "meta"
        assert as_tensor([1.0, 2.0], device="cpu").device.type == "cpu"
        kept = torch.ones(2)
        assert as_tensor(kept) is kept
        assert as_tensor(2.0, like=kept).device.type == "cpu"
        assert ct.SHOTerm(sigma=1.0, rho=2.0, tau=3.0).w0.device.type == "meta"
        # numbers beside a tensor parameter follow that tensor
        assert ct.SHOTerm(sigma=kept, rho=2.0, tau=3.0).eps.device.type == "cpu"
    finally:
        ct.set_config(**prior.__dict__)
    assert ct.get_config().device == "cpu"
    assert ct.Config().device == "cuda"  # the package default is the card


def test_term_from_numpy_places_parameters_on_the_default_device():
    spec = {"type": "TermSum", "terms": [
        {"type": "RealTerm", "params": {"a": 1.0, "c": np.float64(0.5)}},
        {"type": "SHOTerm", "params": {"w0": 1.0, "Q": 2.0, "S0": 1.0, "eps": 1e-5}},
    ]}
    prior = ct.get_config()
    ct.set_config(device="meta")
    try:
        term = term_from_numpy(spec)
        assert term.terms[0].a.device.type == "meta"
        assert term.terms[1].w0.device.type == "meta"
        assert term_from_numpy(spec, device="cpu").terms[0].c.device.type == "cpu"
    finally:
        ct.set_config(**prior.__dict__)
    assert term_from_numpy(spec).terms[1].Q.device.type == "cpu"


def test_default_device_without_a_card_raises():
    """With the package default ("cuda") and no GPU, PyTorch's own error
    surfaces from the first non-tensor: nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    t = np.linspace(0, 1, 10)
    prior = ct.get_config()
    ct.set_config(device="cuda")
    try:
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            ct.gp_loglik(ct.RealTerm(a=t64(1.0), c=t64(1.0)), t, t)
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            ct.GaussianProcess(ct.RealTerm(a=t64(1.0), c=t64(1.0)), t)
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            term_from_numpy({"type": "RealTerm", "params": {"a": 1.0, "c": 1.0}})
        # asking for the CPU per call works under the same default
        ll = ct.gp_loglik(ct.RealTerm(a=t64(1.0), c=t64(1.0)), t, t, device="cpu")
        assert ll.device.type == "cpu" and torch.isfinite(ll)
    finally:
        ct.set_config(**prior.__dict__)
