"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  CUDA kernels have no CPU mode, so without a GPU every test here
skips.  The machine with the card has no JAX, and tests/conftest.py
imports it, so run these there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import celerite2_torch as ct
from celerite2_torch.ops import _build
from celerite2_torch.ops import fused_loglik as fl
from celerite2_torch.ops import scan

pytestmark = pytest.mark.cuda

PLAIN = {
    "kalman_fwd": fl.kalman_fwd_plain,
    "solve_rev": fl.solve_rev_plain,
    "factor_rev": fl.factor_rev_plain,
    "frev_maps": fl.frev_maps_plain,
    "frev_states": fl.frev_states_plain,
}
KERNEL = {
    "kalman_fwd": _build.kalman_fwd_cuda,
    "solve_rev": _build.solve_rev_cuda,
    "factor_rev": _build.factor_rev_cuda,
    "frev_maps": _build.frev_maps_cuda,
    "frev_states": _build.frev_states_cuda,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kernel(J, sigma):
    """J = 2 SHOTerm, 3 RealTerm + SHOTerm, 4 an SHO mixture."""
    sho = ct.SHOTerm(sigma=sigma, rho=3.4, tau=2.9)
    if J == 2:
        return sho
    if J == 3:
        return ct.RealTerm(a=0.4, c=1.7) + sho
    return sho + ct.SHOTerm(sigma=0.6, rho=1.1, Q=0.3)


def _system(N, C, seed=0, J=2):
    """A system of C chains on the CPU (the tests move it to the card)."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, 10, N)), dtype=torch.float64)
    sigma = torch.tensor(rng.uniform(0.8, 1.5, C), dtype=torch.float64)
    c, a, U, V = _kernel(J, sigma).get_celerite_matrices(t, 0.04)
    y = torch.tensor(np.sin(t.numpy()) + 0.2 * rng.normal(size=(C, N)))
    return t, c, a, U, V, y


def _check_kernel(cuda, name, J):
    """Kernel ``name`` against its plain version at N = 300 in blocks of
    16 (a ragged last block), C = 3, float64."""
    args = [x.to(cuda) for x in _system(300, 3, J=J)]
    # K4, K5 at every J (the default route takes them only at J > 2)
    structured = name.startswith("frev")
    inputs = fl.pass_inputs(*args, block_len=16,
                            structured=structured or None)[name]
    before = _build.LAUNCHES[name]
    got = KERNEL[name](*inputs, 16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    want = PLAIN[name](*inputs, 16)
    if structured:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = w.abs().max()
        assert ((g - w).abs().max() / scale).item() < 1e-10


@pytest.mark.parametrize("name", ["factor_rev", "kalman_fwd", "solve_rev"])
def test_kernel_matches_plain(cuda, name):
    _check_kernel(cuda, name, 2)


@pytest.mark.parametrize(
    "name, J",
    [("kalman_fwd", 3), ("kalman_fwd", 4), ("solve_rev", 3), ("solve_rev", 4)]
    + [(k, J) for k in ("frev_maps", "frev_states") for J in (2, 3, 4)],
)
def test_wide_kernel_matches_plain(cuda, name, J):
    """K1, K2 at J = 3, 4 and the structured pair K4, K5 at J = 2..4."""
    _check_kernel(cuda, name, J)


def test_structured_route_matches_dense_on_card(cuda):
    """At J = 2, K4 -> phase B -> K5 gives K3's MX on the card."""
    args = [x.to(cuda) for x in _system(1000, 2, seed=3)]
    inputs = fl.pass_inputs(*args, block_len=64, structured=True)["frev_maps"]
    dense = fl.factor_adjoint(*inputs, 64, structured=False)
    structured = fl.factor_adjoint(*inputs, 64, structured=True)
    scale = dense.abs().max()
    assert ((structured - dense).abs().max() / scale).item() < 1e-10


def _sho(th):
    return ct.SHOTerm(sigma=th[0].exp(), rho=th[1].exp(), tau=th[2].exp())


def _sho_mixture(th):
    return _sho(th) + ct.SHOTerm(sigma=th[3].exp(), rho=th[4].exp(), Q=0.3)


def _rotation(th):
    return ct.RotationTerm(sigma=th[0].exp(), period=th[1].exp(),
                           Q0=th[2].exp(), dQ=th[3].exp(), f=th[4].exp())


@pytest.mark.parametrize(
    "model, theta",
    [(_sho, [0.1, 1.2, 1.0]),
     (_sho_mixture, [0.1, 1.2, 1.0, -0.5, 0.3]),
     (_rotation, [0.2, 1.2, 0.3, 0.0, -0.7])],
    ids=["sho", "sho_mixture", "rotation"],
)
def test_gp_loglik_cuda_matches_cpu(cuda, model, theta):
    t, c, a, U, V, y = _system(2000, 2)
    th = torch.tensor(theta, dtype=torch.float64)

    def value_grad(device):
        th_d = th.to(device).requires_grad_(True)
        ll = ct.gp_loglik(model(th_d), t.to(device), y[0].to(device),
                          yerr=0.2)
        (g,) = torch.autograd.grad(ll, th_d)
        return ll.item(), g.cpu()

    v0, g0 = value_grad(torch.device("cpu"))
    v1, g1 = value_grad(cuda)
    np.testing.assert_allclose(v1, v0, rtol=1e-10)
    torch.testing.assert_close(g1, g0, rtol=1e-9, atol=1e-9 * g0.abs().max())


def test_rotation_term_mixed_device_parameters(cuda):
    """A CUDA sigma with float period, Q0, dQ, f: the matrices come out
    on the card and equal the CPU ones."""
    sigma = torch.tensor([1.0, 1.3], dtype=torch.float64)
    t = torch.linspace(0, 10, 50, dtype=torch.float64)

    def term(s):
        return ct.RotationTerm(sigma=s, period=3.5, Q0=2.0, dQ=1.0, f=0.3)

    got = term(sigma.to(cuda)).get_celerite_matrices(t.to(cuda), 0.1)
    want = term(sigma).get_celerite_matrices(t, 0.1)
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-12, atol=1e-12)


# ------------------------------------------ the general factor and sweeps


def _wide_kernel(J, sigma):
    """A kernel of width J: J // 2 SHOTerms (one overdamped) and, for odd
    J, a RealTerm."""
    terms = [
        ct.SHOTerm(sigma=sigma / (1 + i), rho=1.0 + 1.7 * i,
                   **({"Q": 0.3} if i == 1 else {"tau": 2.0 + i}))
        for i in range(J // 2)
    ]
    if J % 2:
        terms.append(ct.RealTerm(a=0.4 * sigma, c=0.7))
    return terms[0] if len(terms) == 1 else ct.TermSum(*terms)


def _wide_system(N, C, J, K, device, seed=0):
    """``(t (C, N), c, a, U, V, Y (C, N, K))`` of C chains on ``device``."""
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, 10, N)), device=device)
    sigma = torch.tensor(rng.uniform(0.8, 1.5, C), device=device)
    c, a, U, V = _wide_kernel(J, sigma).get_celerite_matrices(t, 0.04)
    Y = torch.tensor(rng.normal(size=(C, N, K)), device=device)
    return tuple(x.contiguous() for x in (t.expand(C, N), c, a, U, V, Y))


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("J", [1, 2, 4, 8, 16, 32])
def test_factor_fwd_matches_plain(cuda, J):
    """The factor kernel against the plain loop (d, W and the cache), at
    N = 301, C = 3, float64, to 1e-10 relative."""
    t, c, a, U, V, _ = _wide_system(301, 3, J, 1, cuda)
    p = scan.transport(t, c)
    before = _build.LAUNCHES["factor_fwd"]
    got = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["factor_fwd"] == before + 1
    for g, w in zip(got, scan.factor_fwd_plain(p, a, U, V)):
        assert g.shape == w.shape and _rel(g, w) < 1e-10
    d, W, none = _build.factor_fwd_cuda(p, a, U, V)
    assert none is None and torch.equal(d, got[0]) and torch.equal(W, got[1])


@pytest.mark.parametrize("is_solve, upper",
                         [(s, u) for s in (True, False) for u in (False, True)])
@pytest.mark.parametrize("J, K", [(1, 1), (2, 4), (4, 1), (8, 5), (16, 1),
                                  (32, 3), (8, 200)])
def test_sweep_fwd_matches_plain(cuda, J, K, is_solve, upper):
    """The sweep kernel in its four modes against the plain loop (Z and the
    cache), at N = 301 (more than one tile at J >= 4), C = 3, float64, to
    1e-10 relative."""
    t, c, a, U, V, Y = _wide_system(301, 3, J, K, cuda)
    d, W, _ = scan.factor_fwd_plain(scan.transport(t, c), a, U, V)
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    p = scan.transport_up(t, c) if upper else scan.transport(t, c)
    before = _build.LAUNCHES["sweep_fwd"]
    got = _build.sweep_fwd_cuda(p, A, B, Y, is_solve, upper, want_cache=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sweep_fwd"] == before + 1
    want = scan.sweep_fwd_plain(p, A, B, Y, is_solve=is_solve, upper=upper)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) < 1e-10
    Z, none = _build.sweep_fwd_cuda(p, A, B, Y, is_solve, upper)
    assert none is None and torch.equal(Z, got[0])


def test_sweep_fwd_long_rows(cuda):
    """Several tiles of rows (N = 5000 at J = 8: 40 tiles) in float32 and
    float64 against the plain loop."""
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        t, c, a, U, V, Y = (
            x.to(dtype) for x in _wide_system(5000, 1, 8, 2, cuda, seed=4))
        p = scan.transport(t, c)
        d, W, S = _build.factor_fwd_cuda(p, a, U, V, want_cache=True)
        for g, w in zip((d, W, S), scan.factor_fwd_plain(p, a, U, V)):
            assert _rel(g, w) < tol
        Z, F = _build.sweep_fwd_cuda(p, U, W, Y, True, False, want_cache=True)
        for g, w in zip((Z, F), scan.sweep_fwd_plain(p, U, W, Y, is_solve=True,
                                                     upper=False)):
            assert _rel(g, w) < tol


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M, J, K, block_len", [
    (1, 1, 1, None), (31, 3, 2, None), (301, 8, 1, None), (5000, 8, 5, None),
    (5000, 2, 130, None), (301, 5, 3, 4), (100_000, 8, 1, None)])
def test_affine_prefix_matches_plain(cuda, M, J, K, block_len, reverse):
    """The blocked affine prefix against the plain doubling and, at small
    M, the row-by-row recurrence, C = 3 (C = 1 at M = 1e5), float64, to
    1e-10 relative: one launch up to one block of rows, three above it,
    and one more pair for each further level (block_len = 4 at M = 301
    nests five levels)."""
    C = 1 if M > 10_000 else 3
    rng = np.random.default_rng(M + J)
    phi = torch.tensor(rng.uniform(0.2, 1.0, (C, M, J)), device=cuda)
    G = torch.tensor(rng.normal(size=(C, M, J, K)), device=cuda)
    before = _build.LAUNCHES["affine_prefix"]
    got = _build.affine_prefix_cuda(phi, G, reverse, block_len)
    torch.cuda.synchronize()
    L, levels, rows = block_len or _build.prefix_block_len(M), 0, M
    while rows > L:
        rows, levels = -(-rows // L), levels + 1
    assert _build.LAUNCHES["affine_prefix"] == before + 2 * levels + 1
    assert _rel(got, scan.affine_prefix_plain(phi, G, reverse=reverse)) < 1e-10
    if M <= 5000:
        F, want = torch.zeros_like(G[:, 0]), [None] * M
        for m in (range(M - 1, -1, -1) if reverse else range(M)):
            F = phi[:, m, :, None] * F + G[:, m]
            want[m] = F
        assert _rel(got, torch.stack(want, 1)) < 1e-10


def test_affine_prefix_float32_and_dispatch(cuda):
    rng = np.random.default_rng(0)
    phi = torch.tensor(rng.uniform(0.2, 1.0, (2, 3000, 4)), device=cuda).float()
    G = torch.tensor(rng.normal(size=(2, 3000, 4, 3)), device=cuda).float()
    want = scan.affine_prefix_plain(phi.double(), G.double())
    assert _rel(scan.affine_prefix(phi, G).double(), want) < 1e-5
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.affine_prefix_cuda(phi.cpu(), G.cpu())
    with pytest.raises(ValueError, match="expected shape"):
        _build.affine_prefix_cuda(phi[:, :-1].contiguous(), G)


@pytest.mark.parametrize("name", ["general_matmul_lower", "general_matmul_upper"])
def test_general_matmul_cuda_matches_cpu_with_gradients(cuda, name):
    """The rectangular products on the card (through the affine prefix
    kernel, forward and backward) against the CPU route: value and the
    gradients with respect to c, U, V and Y."""
    from celerite2_torch import ops

    rng = np.random.default_rng(3)
    t2 = np.sort(rng.uniform(0, 10, 700))
    t1 = np.sort(rng.uniform(-1, 11, 450))
    cpu = [torch.tensor(x) for x in (
        t1, t2, rng.uniform(0.1, 2.0, 5), rng.normal(size=(450, 5)),
        rng.normal(size=(700, 5)), rng.normal(size=(700, 3)))]
    results = []
    for device in ("cpu", cuda):
        args = [x.to(device) for x in cpu]
        for x in args[2:]:
            x.requires_grad_(True)
        before = _build.LAUNCHES["affine_prefix"]
        z = getattr(ops, name)(*args)
        grads = torch.autograd.grad((z * z).sum(), args[2:])
        if device != "cpu":
            # 700 source rows are 22 blocks of 32: three launches forward
            # and three for the adjoint
            assert z.is_cuda and _build.LAUNCHES["affine_prefix"] == before + 6
        results.append([z.detach().cpu()] + [g.cpu() for g in grads])
    for got, want in zip(results[1], results[0]):
        assert got.shape == want.shape and _rel(got, want) < 1e-10


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    t, c, a, U, V, Y = _wide_system(50, 1, 3, 1, cuda)
    p = scan.transport(t, c)
    with pytest.raises(NotImplementedError, match="J must be one of"):
        _build.factor_fwd_cuda(p, a, U, V)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.sweep_fwd_cuda(p.cpu(), U.cpu(), V.cpu(), Y.cpu(), True, False)


@pytest.mark.parametrize("J", [3, 5, 8])
def test_ops_cuda_match_cpu(cuda, J):
    """The public ops (bucketed to 4, 8, 8) on the card against the CPU
    route, one system and three chains."""
    from celerite2_torch import ops

    t, c, a, U, V, Y = _wide_system(400, 3, J, 2, "cpu", seed=J)
    for sl in (slice(None), 0):
        args = [x[sl] for x in (t, c, a, U, V, Y)]
        dev = [x.to(cuda) for x in args]
        d0, W0 = ops.factor(*args[:5])
        d1, W1 = ops.factor(*dev[:5])
        assert d1.is_cuda and W1.shape == W0.shape
        assert _rel(d1.cpu(), d0) < 1e-10 and _rel(W1.cpu(), W0) < 1e-10
        for name in ("solve_lower", "solve_upper", "matmul_lower", "matmul_upper"):
            second = W0 if name.startswith("solve") else args[4]
            z0 = getattr(ops, name)(args[0], args[1], args[3], second, args[5])
            z1 = getattr(ops, name)(dev[0], dev[1], dev[3], second.to(cuda), dev[5])
            assert _rel(z1.cpu(), z0) < 1e-10, name


def test_gaussian_process_defaults_to_the_card(cuda):
    """numpy inputs and no device: the state, and what the methods return,
    are on the card; device="cpu" keeps everything on the CPU."""
    assert ct.get_config().device == "cuda"
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 10, 300))
    y = np.sin(t)
    kernel = ct.SHOTerm(sigma=1.0, rho=3.0, tau=2.0) + ct.RealTerm(a=0.3, c=0.5)
    assert kernel.terms[0].w0.is_cuda
    gp = ct.GaussianProcess(kernel, t, yerr=0.1)
    assert all(x.is_cuda for x in gp.state)
    before = dict(_build.LAUNCHES)
    ll = gp.log_likelihood(y)
    mu, var = gp.predict(y, np.linspace(0, 10, 50), return_var=True)
    assert ll.is_cuda and mu.is_cuda and var.is_cuda
    assert _build.LAUNCHES["sweep_fwd"] > before["sweep_fwd"]
    assert _build.LAUNCHES["affine_prefix"] > before["affine_prefix"]
    assert ct.gp_compute(kernel, t, yerr=0.1).d.is_cuda
    assert ct.gp_loglik(kernel, t, y, yerr=0.1).is_cuda
    spec = {"type": "RealTerm", "params": {"a": 1.0, "c": 0.5}}
    assert ct.models.term_from_numpy(spec).a.is_cuda

    cpu = ct.GaussianProcess(kernel, t, yerr=0.1, device="cpu")
    assert not any(x.is_cuda for x in cpu.state)
    np.testing.assert_allclose(cpu.log_likelihood(y).item(), ll.item(),
                               rtol=1e-10)
    assert not ct.gp_loglik(kernel, t, y, yerr=0.1, device="cpu").is_cuda
    assert not ct.models.term_from_numpy(spec, device="cpu").a.is_cuda


# The adjoints' rings of row tiles: a system at N = 301 rows, one row, one
# row below and one past a tile, odd N in float32 (chains that start off a
# 16-byte boundary), so many chains that a block holds several (the last
# block fewer) and, for the factor, pivots d <= 0.
ADJOINT_EDGES = ["rows_301", "one_row", "tile_minus_one", "tile_plus_one",
                 "odd_rows_float32", "many_chains"]


def _edge_rows(edge, J, K=1, sweep=False):
    """``(N, C, dtype)`` of an edge case of the adjoints' rings."""
    if edge == "one_row":
        return 1, 3, torch.float64
    if edge == "many_chains":
        # the fewest of these chain counts at which a block holds several
        # chains (none does at J = 32 or past 32 right-hand sides), over two
        # tiles of rows
        for C in (257, 513, 1025, 2049, 4097):
            rows, chains, _ = _build.adjoint_ring(torch.float64, J, K, C, sweep)
            if chains > 1:
                return rows + 1, C, torch.float64
        rows, _, _ = _build.adjoint_ring(torch.float64, J, K, 257, sweep)
        return rows + 1, 257, torch.float64
    if edge.startswith("tile"):
        rows, _, _ = _build.adjoint_ring(torch.float64, J, K, sweep=sweep)
        return rows + (1 if edge == "tile_plus_one" else -1), 3, torch.float64
    return 301, 3, torch.float32 if edge == "odd_rows_float32" else torch.float64


def _hold_adjoint(got, want64, want=None):
    """float64: 1e-10 relative against the plain version; float32: against
    the plain version in float64 within 1e-4 or twice the float32 plain
    version's own error, the larger (sums run in another order)."""
    for i, w64 in enumerate(want64):
        g = got[i]
        assert g.shape == w64.shape and g.dtype == (want or want64)[i].dtype
        if not w64.abs().max():  # bU and bp of a single row
            assert not g.abs().max()
        elif g.dtype == torch.float64:
            assert _rel(g, w64) < 1e-10
        else:
            assert _rel(g, w64) <= max(1e-4, 2 * _rel(want[i], w64))


@pytest.mark.parametrize("edge", ADJOINT_EDGES + ["nonpositive_pivots"])
@pytest.mark.parametrize("J", [1, 2, 4, 8, 16, 32])
def test_factor_bwd_matches_plain(cuda, J, edge):
    """The factor adjoint kernel against the plain loop (ba, bU, bV, bp),
    C = 3 (or many chains), at the rings' edges (float64 to 1e-10
    relative)."""
    N, C, dtype = _edge_rows(edge, J)
    t, c, a, U, V, _ = _wide_system(N, C, J, 1, cuda, seed=J)
    p = scan.transport(t, c)
    d, W, S = scan.factor_fwd_plain(p, a, U, V)
    if edge == "nonpositive_pivots":
        d = d.clone()
        d[:, ::7] = -d[:, ::7].abs()
        d[:, 3::11] = 0.0
    rng = np.random.default_rng(J)
    bd = torch.tensor(rng.normal(size=d.shape), device=cuda)
    bW = torch.tensor(rng.normal(size=W.shape), device=cuda)
    args = (p, d, U, W, S, bd, bW)
    want64 = scan.factor_bwd_plain(*args)
    args = tuple(x.to(dtype) for x in args)
    before = _build.LAUNCHES["factor_bwd"]
    got = _build.factor_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["factor_bwd"] == before + 1
    _hold_adjoint(got, want64, scan.factor_bwd_plain(*args))


@pytest.mark.parametrize("edge", ADJOINT_EDGES)
@pytest.mark.parametrize("is_solve, upper",
                         [(s, u) for s in (True, False) for u in (False, True)])
@pytest.mark.parametrize("J, K", [(1, 1), (2, 4), (4, 1), (8, 5), (16, 1),
                                  (32, 3), (8, 200), (4, 32), (2, 33)])
def test_sweep_bwd_matches_plain(cuda, J, K, is_solve, upper, edge):
    """The sweep adjoint kernel in its four modes against the plain loop
    (bA, bB, bp, bY), C = 3 (or many chains), at the rings' edges (float64
    to 1e-10 relative); K = 200 spans seven blocks of right-hand sides, K =
    32 one whole block and K = 33 two."""
    N, C, dtype = _edge_rows(edge, J, K, sweep=True)
    t, c, a, U, V, Y = _wide_system(N, C, J, K, cuda)
    d, W, _ = scan.factor_fwd_plain(scan.transport(t, c), a, U, V)
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    p = scan.transport_up(t, c) if upper else scan.transport(t, c)
    Z, F = scan.sweep_fwd_plain(p, A, B, Y, is_solve=is_solve, upper=upper)
    R = Z if is_solve else Y
    bZ = torch.tensor(np.random.default_rng(K).normal(size=Z.shape), device=cuda)
    args = (p, A, B, R, F, bZ)
    want64 = scan.sweep_bwd_plain(*args, is_solve=is_solve, upper=upper)
    args = tuple(x.to(dtype) for x in args)
    before = _build.LAUNCHES["sweep_bwd"]
    got = _build.sweep_bwd_cuda(*args, is_solve, upper)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sweep_bwd"] == before + 1
    _hold_adjoint(got, want64,
                  scan.sweep_bwd_plain(*args, is_solve=is_solve, upper=upper))


@pytest.mark.parametrize("N", [5000, 5001])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_adjoints_long_rows(cuda, dtype, tol, N):
    """Many tiles of rows (N = 5000, and odd N, whose later chains start off
    a 16-byte boundary) at J = 8, C = 3, in float32 and float64."""
    t, c, a, U, V, Y = (
        x.to(dtype) for x in _wide_system(N, 3, 8, 1, cuda, seed=4))
    p = scan.transport(t, c)
    d, W, S = scan.factor_fwd_plain(p, a, U, V)
    Z, F = scan.sweep_fwd_plain(p, U, W, Y, is_solve=True, upper=False)
    bd, bW = torch.ones_like(d), torch.ones_like(W)
    for g, w in zip(_build.factor_bwd_cuda(p, d, U, W, S, bd, bW),
                    scan.factor_bwd_plain(p, d, U, W, S, bd, bW)):
        assert _rel(g, w) < tol
    for g, w in zip(_build.sweep_bwd_cuda(p, U, W, Z, F, Z, True, False),
                    scan.sweep_bwd_plain(p, U, W, Z, F, Z, is_solve=True,
                                         upper=False)):
        assert _rel(g, w) < tol


@pytest.mark.parametrize("J", [3, 8])
def test_op_gradients_cuda_match_cpu(cuda, J):
    """Gradients of factor, the four sweeps and factor_solve on the card
    (through factor_bwd and sweep_bwd) against the CPU route."""
    from celerite2_torch import ops

    t, c, a, U, V, Y = _wide_system(400, 2, J, 2, "cpu", seed=J)
    rng = np.random.default_rng(J)
    weights = [torch.tensor(rng.normal(size=s)) for s in (a.shape, U.shape, Y.shape)]
    results = []
    for device in ("cpu", cuda):
        args = [x.to(device).requires_grad_(True) for x in (t, c, a, U, V, Y)]
        wd, wW, wZ = (w.to(device) for w in weights)
        d, W = ops.factor(*args[:5])
        loss = (wd * d).sum() + (wW * W).sum()
        for name in ("solve_lower", "solve_upper", "matmul_lower", "matmul_upper"):
            z = getattr(ops, name)(args[0], args[1], args[3], W, args[5])
            loss = loss + (wZ * z).sum()
        d2, W2, Z2 = ops.factor_solve(*args)
        loss = loss + (wd * d2).sum() + (wW * W2).sum() + (wZ * Z2).sum()
        before = dict(_build.LAUNCHES)
        grads = torch.autograd.grad(loss, args)
        if device != "cpu":
            assert _build.LAUNCHES["factor_bwd"] == before["factor_bwd"] + 2
            assert _build.LAUNCHES["sweep_bwd"] == before["sweep_bwd"] + 5
        results.append([g.cpu() for g in grads])
    for got, want in zip(results[1], results[0]):
        assert _rel(got, want) < 1e-9


def test_gp_loglik_gradient_at_j8_cuda_matches_cpu(cuda):
    """gp_loglik value and theta-gradient at J = 8 on the card (factor_fwd,
    sweep_fwd, sweep_bwd, factor_bwd) against the CPU route."""
    rng = np.random.default_rng(2)
    t = torch.tensor(np.sort(rng.uniform(0, 100, 3000)))
    y = torch.tensor(np.sin(t.numpy()) + 0.2 * rng.normal(size=3000))
    theta = torch.tensor([0.1, 0.4, 1.0, -0.2])

    def value_grad(device):
        th = theta.to(device).requires_grad_(True)
        kernel = _wide_kernel(8, th[0].exp()) + ct.SHOTerm(
            sigma=th[1].exp(), rho=th[2].exp(), Q=th[3].exp())
        ll = ct.gp_loglik(kernel, t.to(device), y.to(device), yerr=0.2)
        (g,) = torch.autograd.grad(ll, th)
        return ll.item(), g.cpu()

    v0, g0 = value_grad("cpu")
    before = dict(_build.LAUNCHES)
    v1, g1 = value_grad(cuda)
    for name in ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd"):
        assert _build.LAUNCHES[name] == before[name] + 1, name
    np.testing.assert_allclose(v1, v0, rtol=1e-10)
    assert _rel(g1, g0) < 1e-9


def test_no_cache_without_a_gradient_on_the_card(cuda, monkeypatch):
    """Under torch.no_grad() the ops launch the forward kernels without
    their caches (the serving path's launches); with a gradient to come,
    with them, and the backward launches the adjoint kernels."""
    from celerite2_torch import ops

    asked = []
    for name in ("factor_fwd_cuda", "sweep_fwd_cuda"):
        def spy(*args, _fn=getattr(_build, name)):
            asked.append(args[-1])
            return _fn(*args)
        monkeypatch.setattr(_build, name, spy)
    t, c, a, U, V, Y = (x[0] for x in _wide_system(100, 1, 8, 1, cuda))
    U = U.requires_grad_(True)
    with torch.no_grad():
        d, W = ops.factor(t, c, a, U, V)
        ops.solve_lower(t, c, U, W, Y)
    assert asked == [False, False] and not d.requires_grad
    d, W = ops.factor(t, c, a, U, V)
    z = ops.solve_lower(t, c, U, W, Y)
    assert asked[2:] == [True, True]
    before = dict(_build.LAUNCHES)
    (gU,) = torch.autograd.grad(z.sum() + d.sum(), U)
    assert gU.is_cuda and torch.isfinite(gU).all()
    assert _build.LAUNCHES["sweep_bwd"] == before["sweep_bwd"] + 1
    assert _build.LAUNCHES["factor_bwd"] == before["factor_bwd"] + 1


# ------------------------------------------------ the assoc tier's prefixes


def _riccati_inputs(N, C, J, K, device, seed=0):
    t, c, a, U, V, Y = _wide_system(N, C, J, K, device, seed=seed)
    c, (U, V), _ = ct.ops.api._bucketed(c, U, V)
    return scan.transport(t, c), a, U.contiguous(), V.contiguous(), Y


def _hold_prefix(got, dbl, rows, tol=1e-10):
    """A prefix kernel's outputs against the row-by-row recursion to
    ``tol`` relative, and against the plain doubling to ``tol`` or 1.5
    times the doubling's own distance from the rows, whichever is larger
    (the doubling composes maps of up to N / 2 rows and loses more digits
    than the row recursion the kernel's apply walk runs)."""
    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max().clamp_min(1e-300)).item()

    for g, d, r in zip(got, dbl, rows):
        assert g.shape == d.shape == r.shape
        assert rel(g, r) < tol, rel(g, r)
        assert rel(g, d) < max(tol, 1.5 * rel(d, r)), (rel(g, d), rel(d, r))


@pytest.mark.parametrize("N, block_len", [(1, None), (130, None), (1040, None),
                                          (301, 7), (5000, None)])
@pytest.mark.parametrize("J", [1, 2, 3, 8, 16, 32])
def test_riccati_and_kalman_prefix_match_plain(cuda, J, N, block_len):
    """The Riccati and Kalman prefix kernels against their plain doublings
    and the factor and lower solve's row loop, C = 3, float64, to 1e-10
    relative (``_hold_prefix``): one launch up to one block of rows, three
    above it (block_len = 7 at N = 301: 43 blocks)."""
    from celerite2_torch.ops import prefix_engine as pe

    p, a, U, V, Y = _riccati_inputs(N, 3, J, 20, cuda, seed=J)
    L = block_len or _build.kalman_block_len(N)
    launches = 1 if N <= L else 3
    for key, Yk in (("riccati_prefix", None), ("kalman_prefix", Y[..., :1].contiguous()),
                    ("kalman_prefix", Y)):
        before = _build.LAUNCHES[key]
        got = _build.kalman_prefix_cuda(p, a, U, V, Yk, block_len)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + launches
        _, _, _, S_half, F = scan.factor_solve_plain(
            p, a, U, V, Y[..., :1] if Yk is None else Yk)
        rows = (S_half * p[..., None, :], p[..., :, None] * F)
        if Yk is None:
            got, dbl, rows = (got,), (pe.riccati_prefix_plain(p, a, U, V),), rows[:1]
        else:
            dbl = pe.kalman_prefix_plain(p, a, U, V, Yk)
        _hold_prefix(got, dbl, rows)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M, D, K, block_len", [
    (1, 1, 1, None), (130, 4, 1, None), (1040, 8, 5, None), (301, 3, 2, 4),
    (5000, 8, 1, None), (300, 64, 1, None), (40, 256, 1, None),
    (200, 16, 40, None)])
def test_mat_affine_prefix_matches_plain(cuda, M, D, K, block_len, reverse):
    """The matrix-affine prefix kernel against the plain doubling and the
    row-by-row recurrence (``_hold_prefix``), C = 2, float64, on
    contracting maps of the sizes the solves (D = J) and the factor
    adjoint (D = J^2) give it."""
    from celerite2_torch.ops import prefix_engine as pe

    rng = np.random.default_rng(M + D)
    A = torch.tensor(rng.normal(size=(2, M, D, D)) / (1.5 * np.sqrt(D)),
                     device=cuda)
    b = torch.tensor(rng.normal(size=(2, M, D, K)), device=cuda)
    before = _build.LAUNCHES["mat_affine_prefix"]
    got = _build.mat_affine_prefix_cuda(A, b, reverse, block_len)
    torch.cuda.synchronize()
    L, levels, rows = block_len or _build.prefix_block_len(M), 0, M
    while rows > L:
        rows, levels = -(-rows // L), levels + 1
    assert _build.LAUNCHES["mat_affine_prefix"] == before + 3 * levels + 1
    x, want = torch.zeros_like(b[:, 0]), [None] * M
    for m in (range(M - 1, -1, -1) if reverse else range(M)):
        x = A[:, m] @ x + b[:, m]
        want[m] = x
    _hold_prefix((got,), (pe.mat_affine_prefix_plain(A, b, reverse=reverse),),
                 (torch.stack(want, 1),))


@pytest.mark.parametrize("J", [2, 3, 8])
def test_assoc_tier_cuda_matches_cpu(cuda, J):
    """Every op and its gradient on the assoc tier on the card (the prefix
    kernels) against the CPU's assoc route and the card's scan tier."""
    from celerite2_torch import ops

    t, c, a, U, V, Y = _wide_system(700, 2, J, 2, "cpu", seed=J)
    rng = np.random.default_rng(J)
    weights = [torch.tensor(rng.normal(size=s)) for s in (a.shape, U.shape, Y.shape)]
    results = {}
    prior = ct.get_config()
    try:
        for backend, device in (("assoc", "cpu"), ("assoc", cuda), ("scan", cuda)):
            ct.set_config(backend=backend)
            args = [x.to(device).requires_grad_(True) for x in (t, c, a, U, V, Y)]
            wd, wW, wZ = (w.to(device) for w in weights)
            before = dict(_build.LAUNCHES)
            d, W = ops.factor(*args[:5])
            loss = (wd * d).sum() + (wW * W).sum()
            for name in ("solve_lower", "solve_upper", "matmul_lower", "matmul_upper"):
                z = getattr(ops, name)(args[0], args[1], args[3], W, args[5])
                loss = loss + (wZ * z).sum()
            d2, W2, Z2 = ops.factor_solve(*args)
            loss = loss + (wd * d2).sum() + (wW * W2).sum() + (wZ * Z2).sum()
            grads = torch.autograd.grad(loss, args)
            if device != "cpu" and backend == "assoc":
                for key in ("riccati_prefix", "kalman_prefix", "mat_affine_prefix"):
                    assert _build.LAUNCHES[key] > before[key], key
                for key in ("factor_fwd", "sweep_fwd", "factor_bwd", "sweep_bwd"):
                    assert _build.LAUNCHES[key] == before[key], key
            results[backend, str(device)] = [
                x.detach().cpu() for x in (d, W, Z2, *grads)]
    finally:
        ct.set_config(**prior.__dict__)
    want = results["assoc", "cpu"]
    for key in (("assoc", str(cuda)), ("scan", str(cuda))):
        for got, w in zip(results[key], want):
            assert _rel(got, w) < 1e-9, key


def test_assoc_tier_nonpd_is_quiet_on_card(cuda):
    """A system that is not positive definite on the assoc tier: -inf and
    zero gradients from gp_loglik at J = 8."""
    rng = np.random.default_rng(5)
    t = torch.tensor(np.sort(rng.uniform(0, 100, 3000)), device=cuda)
    y = torch.sin(t)
    prior = ct.get_config()
    try:
        ct.set_config(backend="assoc")
        th = torch.tensor(0.1, device=cuda, requires_grad=True)
        ll = ct.gp_loglik(_wide_kernel(8, th.exp()), t, y, diag=-5.0)
        (g,) = torch.autograd.grad(ll, th)
    finally:
        ct.set_config(**prior.__dict__)
    assert ll.item() == -np.inf and g.item() == 0.0


def test_auto_routes_by_the_measured_rule(cuda):
    """"auto" on the card: a single float64 system at J = 4 from 1e5 rows
    takes the assoc tier (riccati_prefix), below it and at J = 8 the scan
    tier (factor_fwd), as dispatch.ASSOC_MIN_ROWS says."""
    from celerite2_torch import ops

    assert ct.get_config().backend == "auto"
    for J, N, kernel in ((4, 100_000, "riccati_prefix"), (4, 20_000, "factor_fwd"),
                         (8, 100_000, "factor_fwd")):
        t, c, a, U, V, _ = (x[0] for x in _wide_system(N, 1, J, 1, cuda))
        before = _build.LAUNCHES[kernel]
        ops.factor(t, c, a, U, V)
        assert _build.LAUNCHES[kernel] > before, (J, N, kernel)
