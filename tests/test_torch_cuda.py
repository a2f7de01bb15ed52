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
from celerite2_torch.ops import layout
from celerite2_torch.probes import transpose as layout_probe

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
    """J = 1 RealTerm, 2 SHOTerm, 3 RealTerm + SHOTerm, 4 an SHO mixture."""
    if J == 1:
        return ct.RealTerm(a=sigma, c=0.7)
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


def _as_tuple(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _check_kernel(cuda, name, J):
    """Kernel ``name`` against its plain version at N = 300 in blocks of
    16 (a ragged last block), C = 3, float64, on the card too.  K1, K2 and
    K3 launch two kernels there (the block maps, the rows: 19 blocks are
    one group, which needs no scan); K4 one (the block maps and their
    suffixes within the group), and K5, from K4's suffixes, one (the
    rows)."""
    args = [x.to(cuda) for x in _system(300, 3, J=J)]
    # K4, K5 at every J (the default route takes them only at J > 2)
    structured = name.startswith("frev")
    inputs = fl.pass_inputs(*args, block_len=16,
                            structured=structured or None)[name]
    if name == "frev_states":
        inputs = (*inputs[:5], *KERNEL["frev_maps"](*inputs[:5], 16))
    before = _build.LAUNCHES[name]
    got = _as_tuple(KERNEL[name](*inputs, 16))
    torch.cuda.synchronize()
    launches = 1 if name.startswith("frev") else 2
    assert _build.LAUNCHES[name] == before + launches
    want = _as_tuple(PLAIN[name](*inputs, 16))
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


# K1, K2, K3 and K5 (each the whole two-level scan on the card): one row,
# one row below and past a tile of rows and a block, a ragged last block, 3
# and 64 chains, many groups of blocks (a ragged last one), more groups than
# the threads of the scan over them (301 groups of 32 one-row blocks: runs
# of three groups a thread, a ragged last), float32, and the card's own
# block length at N = 5000
K12_EDGES = {
    "one_row": (1, 3, None, torch.float64),
    "tile_minus_one": (7, 3, None, torch.float64),
    "tile_plus_one": (9, 3, None, torch.float64),
    "block_minus_one": (63, 3, 64, torch.float64),
    "block_plus_one": (65, 3, 64, torch.float64),
    "ragged_blocks": (300, 3, 32, torch.float64),
    "chains_64": (1000, 64, 32, torch.float64),
    "many_groups": (3001, 3, 8, torch.float64),
    "runs_of_groups": (9601, 3, 1, torch.float64),
    "float32": (1000, 3, 32, torch.float32),
    "own_block_len": (5000, 3, None, torch.float64),
}


def _k12_inputs(cuda, name, J, N, C, dtype):
    """K1's or K2's inputs on the card from the fused path of C chains."""
    args = [x.to(cuda) for x in _system(N, C, seed=N + J, J=J)]
    return [x.to(dtype) for x in fl.pass_inputs(*args)[name]]


@pytest.mark.parametrize("edge", list(K12_EDGES))
@pytest.mark.parametrize("J", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["kalman_fwd", "solve_rev"])
def test_fused_k12_edges_match_plain(cuda, name, J, edge):
    N, C, block_len, dtype = K12_EDGES[edge]
    inputs = _k12_inputs(cuda, name, J, N, C, dtype)
    got = _as_tuple(KERNEL[name](*inputs, block_len))
    L = 16 if block_len is None else block_len
    want64 = _as_tuple(PLAIN[name](*(x.double() for x in inputs), L))
    want = _as_tuple(PLAIN[name](*inputs, L))
    _hold(got, want64, want)


@pytest.mark.parametrize("edge", list(K12_EDGES))
@pytest.mark.parametrize("name, J", [("factor_rev", 1), ("factor_rev", 2)]
                         + [("frev_states", J) for J in (1, 2, 3, 4)])
def test_factor_adjoint_edges_match_plain(cuda, name, J, edge):
    """K3 and K5 against their plain versions at K1's and K2's edges: the
    card route (K5 from K4's maps) against the plain route (the plain K5
    from the plain K4's maps), K3's plain version in blocks of 16 rows."""
    N, C, block_len, dtype = K12_EDGES[edge]
    args = [x.to(cuda) for x in _system(N, C, seed=N + J, J=J)]
    structured = name == "frev_states"
    inputs = fl.pass_inputs(*args, structured=structured)
    fin = [x.to(dtype) for x in inputs["frev_maps" if structured else name]]
    if structured:
        L = _build.structured_block_len(N, C) if block_len is None else block_len
        got = KERNEL[name](*fin, *KERNEL["frev_maps"](*fin, L), L)

        def plain(xs):
            return PLAIN[name](*xs, *PLAIN["frev_maps"](*xs, L), L)
    else:
        got = KERNEL[name](*fin, block_len)

        def plain(xs):
            return PLAIN[name](*xs, 16)
    _hold((got,), (plain([x.double() for x in fin]),), (plain(fin),))


@pytest.mark.parametrize("edge", list(K12_EDGES))
@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_frev_maps_edges_match_plain(cuda, J, edge):
    """K4's suffixes within groups and group maps against its plain
    version at K1's and K2's edges (float64 1e-10; float32 within 1e-4 or
    twice the plain float32 version's error, against the plain float64):
    one launch with more than one block; with one block none, and no
    maps."""
    N, C, block_len, dtype = K12_EDGES[edge]
    args = [x.to(cuda) for x in _system(N, C, seed=N + J, J=J)]
    fin = [x.to(dtype) for x in fl.pass_inputs(*args, structured=True)["frev_maps"]]
    L = _build.structured_block_len(N, C) if block_len is None else block_len
    before = _build.LAUNCHES["frev_maps"]
    got = KERNEL["frev_maps"](*fin, L)
    torch.cuda.synchronize()
    if -(-N // L) == 1:
        assert got == (None, None)
        assert _build.LAUNCHES["frev_maps"] == before
        return
    assert _build.LAUNCHES["frev_maps"] == before + 1
    _hold(got, PLAIN["frev_maps"](*(x.double() for x in fin), L),
          PLAIN["frev_maps"](*fin, L))


# N, rows a block: one block; one group of 32 blocks; 98 groups (the card's
# 32 rows a block at N = 1e5)
@pytest.mark.parametrize("N, block_len, launches",
                         [(100, 128, 1), (1024, 32, 2), (100_000, None, 3)])
def test_structured_factor_adjoint_launches(cuda, N, block_len, launches):
    """The structured factor adjoint (K4 -> K5) launches 3 kernels with
    more than one group of blocks (K4; K5's scan over the groups and its
    rows), 2 with one group and 1 with one block, and agrees with its
    plain route in the card's blocks."""
    args = [x.to(cuda) for x in _system(N, 1, seed=5, J=4)]
    fin = fl.pass_inputs(*args, structured=True)["frev_maps"]
    L = _build.structured_block_len(N) if block_len is None else block_len
    before = dict(_build.LAUNCHES)
    suffix, groups = KERNEL["frev_maps"](*fin, L)
    MX = KERNEL["frev_states"](*fin, suffix, groups, L)
    torch.cuda.synchronize()
    made = sum(_build.LAUNCHES[k] - before[k] for k in ("frev_maps", "frev_states"))
    assert made == launches
    want = PLAIN["frev_states"](*fin, *PLAIN["frev_maps"](*fin, L), L)
    assert _rel(MX, want) < (1e-9 if N > 10_000 else 1e-10)


@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_kalman_fwd_nonpositive_pivots(cuda, J):
    """A diagonal that turns negative from row N // 3 on: K1's states are
    finite, equal the plain version's up to the first row whose pivot
    d = a - u^T S u is not positive, and give the same verdict d > 0 per
    chain (the quiet -inf)."""
    N, C = 300, 3
    t, c, a, U, V, y = (x.to(cuda) for x in _system(N, C, seed=7, J=J))
    a = torch.where(torch.arange(N, device=cuda) >= N // 3, -1.0, a)
    inputs = fl.pass_inputs(t, c, a, U, V, y)["kalman_fwd"]
    S, F = KERNEL["kalman_fwd"](*inputs, 8)
    Sp, Fp = PLAIN["kalman_fwd"](*inputs, 32)
    assert torch.isfinite(S).all() and torch.isfinite(F).all()
    dk, dp = (a - (U * (x @ U[..., None])[..., 0]).sum(-1) for x in (S, Sp))
    assert torch.equal((dk > 0).all(-1), (dp > 0).all(-1))
    assert not (dp > 0).all(-1).any()
    rows = slice(0, int((dp <= 0).int().argmax(-1).min()) + 1)
    assert _rel(S[:, rows], Sp[:, rows]) < 1e-10
    assert _rel(F[:, rows], Fp[:, rows]) < 1e-10


@pytest.mark.parametrize("model", ["sho", "sho_mixture"])
def test_card_route_runs_no_cross_block_level(cuda, monkeypatch, model):
    """The CUDA route of loglik_fused leaves every cross-block level to its
    kernels, K1, K2 and K3 (J = 2) or K5 (J = 4): elements.
    exclusive_block_states and fused_loglik.frev_seeds, patched to raise,
    are never called on the card, and the value and gradient equal the CPU
    route's."""
    from celerite2_torch.ops import elements as el

    fn, theta = {"sho": (_sho, [0.0, 1.2, 1.0]),
                 "sho_mixture": (_sho_mixture, [0.0, 1.2, 1.0, -0.5, 0.1])}[model]
    t = torch.tensor(np.sort(np.random.default_rng(1).uniform(0, 100, 3000)))
    y = torch.sin(t)

    def value_and_grad(dev):
        th = torch.tensor(theta, dtype=torch.float64, device=dev,
                          requires_grad=True)
        ll = ct.gp_loglik(fn(th), t.to(dev), y.to(dev), yerr=0.3)
        (g,) = torch.autograd.grad(ll, th)
        return ll.detach().cpu(), g.cpu()

    v0, g0 = value_and_grad("cpu")

    def guarded(*args, **kwargs):
        raise AssertionError("a cross-block level ran in PyTorch")

    monkeypatch.setattr(el, "exclusive_block_states", guarded)
    monkeypatch.setattr(fl, "frev_seeds", guarded)
    v1, g1 = value_and_grad(cuda)
    assert abs((v1 - v0) / v0).item() < 1e-10
    assert _rel(g1, g0) < 1e-9


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


# The rings of row tiles: a system at N = 301 rows, one row, one row below
# and one past a tile, odd N in float32 (chains that start off a 16-byte
# boundary), so many chains that a block holds several (the last block
# fewer) and, for the factor and its adjoint, pivots d <= 0.
RING_EDGES = ["rows_301", "one_row", "tile_minus_one", "tile_plus_one",
              "odd_rows_float32", "many_chains"]


def _edge_rows(edge, J, K=1, name="factor_bwd"):
    """``(N, C, dtype)`` of an edge case of the ring of the row kernel
    ``name`` (the forward kernels' with their caches)."""
    def plan(C=1):
        return _build.ring(name, torch.float64, J, K, C, cache=True)

    if edge == "one_row":
        return 1, 3, torch.float64
    if edge == "many_chains":
        # the fewest of these chain counts at which a block holds several
        # chains (none does at J = 32 or past 32 right-hand sides), over two
        # tiles of rows
        for C in (257, 513, 1025, 2049, 4097):
            rows, chains, _ = plan(C)
            if chains > 1:
                return rows + 1, C, torch.float64
        return plan(257)[0] + 1, 257, torch.float64
    if edge.startswith("tile"):
        rows = plan()[0]
        return rows + (1 if edge == "tile_plus_one" else -1), 3, torch.float64
    return 301, 3, torch.float32 if edge == "odd_rows_float32" else torch.float64


def _hold(got, want64, want=None):
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


@pytest.mark.parametrize("edge", RING_EDGES + ["nonpositive_pivots"])
@pytest.mark.parametrize("J", [1, 2, 4, 8, 16, 32])
def test_factor_fwd_matches_plain(cuda, J, edge):
    """The factor kernel against the plain loop (d, W and the cache), C = 3
    (or many chains), at the ring's edges (float64 to 1e-10 relative);
    without the cache d and W are the same bits."""
    N, C, dtype = _edge_rows(edge, J, name="factor_fwd")
    t, c, a, U, V, _ = _wide_system(N, C, J, 1, cuda)
    if edge == "nonpositive_pivots":
        a = a.clone()
        a[:, 7] = 0.0
        a[:, 100] = -1.0
    p = scan.transport(t, c)
    want64 = scan.factor_fwd_plain(p, a, U, V)
    if edge == "nonpositive_pivots":
        assert (want64[0] <= 0).any()
    args = tuple(x.to(dtype) for x in (p, a, U, V))
    before = _build.LAUNCHES["factor_fwd"]
    got = _build.factor_fwd_cuda(*args, want_cache=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["factor_fwd"] == before + 1
    _hold(got, want64, scan.factor_fwd_plain(*args))
    d, W, none = _build.factor_fwd_cuda(*args)
    assert none is None and torch.equal(d, got[0]) and torch.equal(W, got[1])


@pytest.mark.parametrize("edge", RING_EDGES)
@pytest.mark.parametrize("is_solve, upper",
                         [(s, u) for s in (True, False) for u in (False, True)])
@pytest.mark.parametrize("J, K", [(1, 1), (2, 4), (4, 1), (8, 5), (16, 1),
                                  (32, 3), (8, 200), (4, 32), (2, 33)])
def test_sweep_fwd_matches_plain(cuda, J, K, is_solve, upper, edge):
    """The sweep kernel in its four modes against the plain loop (Z and the
    cache), C = 3 (or many chains), at the ring's edges (float64 to 1e-10
    relative); K = 200 spans seven blocks of right-hand sides, K = 32 one
    whole block and K = 33 two; without the cache Z is the same bits."""
    N, C, dtype = _edge_rows(edge, J, K, name="sweep_fwd")
    t, c, a, U, V, Y = _wide_system(N, C, J, K, cuda)
    d, W, _ = scan.factor_fwd_plain(scan.transport(t, c), a, U, V)
    second = W if is_solve else V
    A, B = (second, U) if upper else (U, second)
    p = scan.transport_up(t, c) if upper else scan.transport(t, c)
    want64 = scan.sweep_fwd_plain(p, A, B, Y, is_solve=is_solve, upper=upper)
    args = tuple(x.to(dtype) for x in (p, A, B, Y))
    before = _build.LAUNCHES["sweep_fwd"]
    got = _build.sweep_fwd_cuda(*args, is_solve, upper, want_cache=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sweep_fwd"] == before + 1
    _hold(got, want64,
          scan.sweep_fwd_plain(*args, is_solve=is_solve, upper=upper))
    Z, none = _build.sweep_fwd_cuda(*args, is_solve, upper)
    assert none is None and torch.equal(Z, got[0])


@pytest.mark.parametrize("N", [5000, 5001])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_sweep_fwd_long_rows(cuda, dtype, tol, N):
    """Many tiles of rows (N = 5000 at J = 8, and odd N, whose later
    chains' a starts off a 16-byte boundary), C = 3, in float32 and
    float64: the factor and the lower solve against the plain loop."""
    t, c, a, U, V, Y = (
        x.to(dtype) for x in _wide_system(N, 3, 8, 2, cuda, seed=4))
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
    (5000, 2, 130, None), (301, 5, 3, 4), (10_000, 8, 1, 1),
    (10_000, 4, 500, None), (100_000, 8, 1, None), (100_000, 8, 1, 32)])
def test_affine_prefix_matches_plain(cuda, M, J, K, block_len, reverse):
    """The diagonal-affine prefix against the plain doubling and, up to
    M = 1e4, the row-by-row recurrence, C = 3 (C = 1 at M = 1e5), float64,
    to 1e-10 relative: one launch whatever the rows, tiles of 32 runs of
    ``block_len`` rows (M = 1e4 in runs of one row: 313 tiles, a look-back
    over many windows of 32; K = 500: chunks of eight entries)."""
    C = 1 if M > 10_000 else 3
    rng = np.random.default_rng(M + J)
    phi = torch.tensor(rng.uniform(0.2, 1.0, (C, M, J)), device=cuda)
    G = torch.tensor(rng.normal(size=(C, M, J, K)), device=cuda)
    before = _build.LAUNCHES["affine_prefix"]
    got = _build.affine_prefix_cuda(phi, G, reverse, block_len)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["affine_prefix"] == before + 1
    assert _rel(got, scan.affine_prefix_plain(phi, G, reverse=reverse)) < 1e-10
    if M <= 10_000:
        F, want = torch.zeros_like(G[:, 0]), [None] * M
        for m in (range(M - 1, -1, -1) if reverse else range(M)):
            F = phi[:, m, :, None] * F + G[:, m]
            want[m] = F
        assert _rel(got, torch.stack(want, 1)) < 1e-10


@pytest.mark.parametrize("C", [64, 1023])
def test_affine_prefix_at_many_chains(cuda, C):
    """C = 64 and 1023 chains (tickets across sequences), J = 4, K = 2,
    M = 3000 in runs of 4 rows (24 tiles a sequence), against the doubling
    (1e-10)."""
    rng = np.random.default_rng(C)
    phi = torch.tensor(rng.uniform(0.2, 1.0, (C, 3000, 4)), device=cuda)
    G = torch.tensor(rng.normal(size=(C, 3000, 4, 2)), device=cuda)
    got = _build.affine_prefix_cuda(phi, G, True, 4)
    assert _rel(got, scan.affine_prefix_plain(phi, G, reverse=True)) < 1e-10


def test_affine_prefix_float32(cuda):
    """Float32, J = 8, K = 1, M = 1e4, against the float64 row recurrence:
    within max(1e-4, 2 x the float32 plain doubling's error against it)."""
    rng = np.random.default_rng(8)
    phi = torch.tensor(rng.uniform(0.2, 1.0, (3, 10_000, 8)), device=cuda)
    G = torch.tensor(rng.normal(size=(3, 10_000, 8, 1)), device=cuda)
    want = scan.affine_prefix_plain(phi, G)
    F, rows = torch.zeros_like(G[:, 0]), [None] * 10_000
    for m in range(10_000):
        F = phi[:, m, :, None] * F + G[:, m]
        rows[m] = F
    rows = torch.stack(rows, 1)
    assert _rel(want, rows) < 1e-10
    got = _build.affine_prefix_cuda(phi.float(), G.float())
    plain = scan.affine_prefix_plain(phi.float(), G.float())
    tol = max(1e-4, 2 * _rel(plain.double(), rows))
    assert torch.isfinite(got).all() and _rel(got.double(), rows) < tol


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
            # one launch forward and one for the adjoint
            assert z.is_cuda and _build.LAUNCHES["affine_prefix"] == before + 2
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


@pytest.mark.parametrize("edge", RING_EDGES + ["nonpositive_pivots"])
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
    _hold(got, want64, scan.factor_bwd_plain(*args))


@pytest.mark.parametrize("edge", RING_EDGES)
@pytest.mark.parametrize("is_solve, upper",
                         [(s, u) for s in (True, False) for u in (False, True)])
@pytest.mark.parametrize("J, K", [(1, 1), (2, 4), (4, 1), (8, 5), (16, 1),
                                  (32, 3), (8, 200), (4, 32), (2, 33)])
def test_sweep_bwd_matches_plain(cuda, J, K, is_solve, upper, edge):
    """The sweep adjoint kernel in its four modes against the plain loop
    (bA, bB, bp, bY), C = 3 (or many chains), at the rings' edges (float64
    to 1e-10 relative); K = 200 spans seven blocks of right-hand sides, K =
    32 one whole block and K = 33 two."""
    N, C, dtype = _edge_rows(edge, J, K, name="sweep_bwd")
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
    _hold(got, want64,
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


def _prefix_launches(N, L, J):
    """Launches of one Riccati or Kalman prefix call: the rows of one
    block.  With more blocks, at J <= 4 the block maps (with their scan
    within each group) and the rows, and with more than one group the scan
    over the groups too; from J = 8 the block maps, the states entering
    them and the rows, and with more than one group the group maps and the
    scan over them too."""
    from celerite2_torch.ops import prefix_engine as pe

    NB = -(-N // L)
    if NB == 1:
        return 1
    if NB <= pe.KERNEL_GROUP:
        return 2 if J <= 4 else 3
    return 3 if J <= 4 else 5


def _prefix_rows(p, a, U, V, Y):
    """S and F after every row by the factor and lower solve's row loop."""
    _, _, _, S_half, F = scan.factor_solve_plain(p, a, U, V, Y)
    return S_half * p[..., None, :], p[..., :, None] * F


# (N, block_len): one row; below one block; 43 blocks (two groups); one
# group of 32 blocks of 4 rows and a row either side; 9601 one-row blocks
# (301 groups); the rules' own lengths
PREFIX_ROWS = [(1, None), (130, None), (1040, None), (301, 7), (5000, None),
               (127, 4), (128, 4), (129, 4), (9601, 1)]


@pytest.mark.parametrize("N, block_len", PREFIX_ROWS)
@pytest.mark.parametrize("J", [1, 2, 3, 8, 16, 32])
def test_riccati_and_kalman_prefix_match_plain(cuda, J, N, block_len):
    """The Riccati and Kalman prefix kernels against their plain doublings
    and the factor and lower solve's row loop, C = 3, float64, to 1e-10
    relative (``_hold_prefix``), without right-hand sides and with K = 1,
    16, 17, 20 and 40 (column chunks of csrc/assoc_prefix.cu ric_cols);
    launches per call (``_prefix_launches``); the group of the CPU's
    plain version of the kernels' order is the kernels' own."""
    from celerite2_torch.ops import prefix_engine as pe

    assert _build._library().c2t_riccati_group() == pe.KERNEL_GROUP
    p, a, U, V, Y = _riccati_inputs(N, 3, J, 40, cuda, seed=J)
    L = block_len or _build.kalman_block_len(N, U.shape[-1])
    # each right-hand side's leaves depend on its own column only: one
    # doubling and one row loop at K = 40 serve every K
    rows = _prefix_rows(p, a, U, V, Y)
    dbl = pe.kalman_prefix_plain(p, a, U, V, Y)
    for K in (0, 1, 16, 17, 20, 40):
        key = "kalman_prefix" if K else "riccati_prefix"
        before = _build.LAUNCHES[key]
        got = _build.kalman_prefix_cuda(p, a, U, V, Y[..., :K].contiguous()
                                        if K else None, block_len)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + _prefix_launches(N, L, J), K
        if K:
            _hold_prefix(got, (dbl[0], dbl[1][..., :K]), (rows[0], rows[1][..., :K]))
        else:
            _hold_prefix((got,), dbl[:1], rows[:1])


@pytest.mark.parametrize("C", [64, 1023])
def test_riccati_and_kalman_prefix_at_many_chains(cuda, C):
    """C = 64 and 1023 chains at J = 4, N = 300 in blocks of 16 rows (19
    blocks), K = 1, against the row loop and the doubling (1e-10)."""
    from celerite2_torch.ops import prefix_engine as pe

    p, a, U, V, Y = _riccati_inputs(300, C, 4, 1, cuda, seed=C)
    S, F = _build.kalman_prefix_cuda(p, a, U, V, Y, 16)
    S0 = _build.riccati_prefix_cuda(p, a, U, V, 16)
    torch.cuda.synchronize()
    rows = _prefix_rows(p, a, U, V, Y)
    dbl = pe.kalman_prefix_plain(p, a, U, V, Y)
    _hold_prefix((S, F, S0), dbl + dbl[:1], rows + rows[:1])


@pytest.mark.parametrize("J", [2, 8])
def test_riccati_and_kalman_prefix_nonpositive_pivot(cuda, J):
    """Row N - 2 of N = 200 with its diagonal cut to 5%, so that its pivot
    d is negative, in the last of 13 blocks of 16 rows (C7): every value
    finite; the rows up to that pivot as the plain doubling's (1e-10); and
    every row as the row loop's, which divides by 1 where d <= 0 as the
    kernels do (the doubling divides by d)."""
    from celerite2_torch.ops import prefix_engine as pe

    N = 200
    p, a, U, V, Y = _riccati_inputs(N, 3, J, 2, cuda, seed=J)
    a = a.clone()
    a[:, N - 2] *= 0.05
    d = scan.factor_solve_plain(p, a, U, V, Y)[0]
    assert (d[:, N - 2] < 0).all() and (d[:, : N - 2] > 0).all()
    S, F = _build.kalman_prefix_cuda(p, a, U, V, Y, 16)
    torch.cuda.synchronize()
    assert torch.isfinite(S).all() and torch.isfinite(F).all()
    rows = _prefix_rows(p, a, U, V, Y)
    dbl = pe.kalman_prefix_plain(p, a, U, V, Y)
    before = lambda xs: [x[:, : N - 1] for x in xs]  # noqa: E731
    _hold_prefix(before((S, F)), before(dbl), before(rows))
    for g, r in zip((S, F), rows):
        assert _rel(g, r) < 1e-10


@pytest.mark.parametrize("J", [2, 8])
def test_riccati_and_kalman_prefix_float32(cuda, J):
    """Float32 at J = 2, 8, N = 1040 in blocks of 8 (130 blocks), K = 1,
    against the float64 row loop: within max(1e-4, 2 x the float32 plain
    doubling's error against it), the float32 gate of the kernels
    (PERF.md, PR 8)."""
    from celerite2_torch.ops import prefix_engine as pe

    p, a, U, V, Y = _riccati_inputs(1040, 3, J, 1, cuda, seed=J)
    rows = _prefix_rows(p, a, U, V, Y)
    x32 = [x.float() for x in (p, a, U, V, Y)]
    got = _build.kalman_prefix_cuda(*x32, block_len=8)
    plain = pe.kalman_prefix_plain(*x32)
    for g, d, r in zip(got, plain, rows):
        tol = max(1e-4, 2 * _rel(d.double(), r))
        assert torch.isfinite(g).all() and _rel(g.double(), r) < tol


def _mat_affine_launches(M, D, L):
    """Launches of one matrix-affine prefix call: above D = 32 one walk;
    up to it the rows of one block, with more blocks the block maps (with
    their scan within each group) too, and with more than one group the
    scan over the groups."""
    if D > 32:
        return 1
    NB = -(-M // L)
    GB = -(-NB // _build._library().c2t_mat_affine_group(D))
    return 1 + (NB > 1) + (GB > 1)


def _mat_affine_rows(A, b, reverse):
    x, rows = torch.zeros_like(b[:, 0]), [None] * b.shape[1]
    for m in (range(b.shape[1] - 1, -1, -1) if reverse else range(b.shape[1])):
        x = A[:, m] @ x + b[:, m]
        rows[m] = x
    return torch.stack(rows, 1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("M, D, K, block_len", [
    (1, 1, 1, None), (130, 4, 1, None), (1040, 8, 5, None), (301, 3, 2, 4),
    (5000, 8, 1, None), (300, 64, 1, None), (40, 256, 1, None),
    (200, 16, 40, None), (129, 2, 3, 2), (129, 8, 1, 4), (10_000, 4, 1, None),
    (10_000, 8, 1, 1), (10_000, 32, 1, None), (3000, 1, 9, 2),
    (1000, 8, 500, None), (98, 64, 1, None)])
def test_mat_affine_prefix_matches_plain(cuda, M, D, K, block_len, reverse):
    """The matrix-affine prefix kernels against the plain doubling and the
    row-by-row recurrence (``_hold_prefix``), C = 2, float64, on
    contracting maps of the sizes the solves (D = J, K up to 500) and the
    factor adjoint (D = J^2: 64 at M = 98, phase B's shape at J = 8, the
    route above D = 32) give them; several groups (M = 129 in blocks of 2
    at D = 2 and of 4 at D = 8, 1e4 in one-row blocks), padded widths
    (D = 3); launches per call
    (``_mat_affine_launches``)."""
    from celerite2_torch.ops import prefix_engine as pe

    assert all(_build._library().c2t_mat_affine_group(D) == pe.mat_affine_group(D)
               for D in (1, 2, 3, 4, 8, 16, 32, 64))
    rng = np.random.default_rng(M + D)
    A = torch.tensor(rng.normal(size=(2, M, D, D)) / (1.5 * np.sqrt(D)),
                     device=cuda)
    b = torch.tensor(rng.normal(size=(2, M, D, K)), device=cuda)
    before = _build.LAUNCHES["mat_affine_prefix"]
    got = _build.mat_affine_prefix_cuda(A, b, reverse, block_len)
    torch.cuda.synchronize()
    L = block_len or _build.mat_affine_block_len(M, D)
    assert _build.LAUNCHES["mat_affine_prefix"] == before + _mat_affine_launches(M, D, L)
    _hold_prefix((got,), (pe.mat_affine_prefix_plain(A, b, reverse=reverse),),
                 (_mat_affine_rows(A, b, reverse),))


@pytest.mark.parametrize("C", [64, 1023])
def test_mat_affine_prefix_at_many_chains(cuda, C):
    """C = 64 and 1023 chains at D = 4 and 8, M = 300 in blocks of 2 rows
    (150 blocks: three groups at D = 4, five at D = 8), K = 1, against the
    row loop and the doubling (1e-10)."""
    from celerite2_torch.ops import prefix_engine as pe

    rng = np.random.default_rng(C)
    for D in (4, 8):
        A = torch.tensor(rng.normal(size=(C, 300, D, D)) / (1.5 * np.sqrt(D)),
                         device=cuda)
        b = torch.tensor(rng.normal(size=(C, 300, D, 1)), device=cuda)
        got = _build.mat_affine_prefix_cuda(A, b, False, 2)
        _hold_prefix((got,), (pe.mat_affine_prefix_plain(A, b),),
                     (_mat_affine_rows(A, b, False),))


@pytest.mark.parametrize("D", [2, 8, 64])
def test_mat_affine_prefix_float32(cuda, D):
    """Float32 at D = 2, 8 (M = 1040 in blocks of 8: 130 blocks) and 64
    (M = 98), K = 1, against the float64 row recursion: within
    max(1e-4, 2 x the float32 plain doubling's error against it)."""
    from celerite2_torch.ops import prefix_engine as pe

    M = 98 if D > 32 else 1040
    rng = np.random.default_rng(D)
    A = torch.tensor(rng.normal(size=(3, M, D, D)) / (1.5 * np.sqrt(D)),
                     device=cuda)
    b = torch.tensor(rng.normal(size=(3, M, D, 1)), device=cuda)
    rows = _mat_affine_rows(A, b, False)
    got = _build.mat_affine_prefix_cuda(A.float(), b.float(), False, 8)
    plain = pe.mat_affine_prefix_plain(A.float(), b.float())
    tol = max(1e-4, 2 * _rel(plain.double(), rows))
    assert torch.isfinite(got).all() and _rel(got.double(), rows) < tol


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


def _wide8(theta):
    """chip_smoke.py's J = 8 model: four SHOTerms as a function of theta =
    log[sigma, rho, tau], the last at Q = 0.5."""
    e = theta.exp()
    k = ct.SHOTerm(sigma=e[..., 0], rho=e[..., 1], tau=e[..., 2])
    for j in range(3):
        k = k + ct.SHOTerm(sigma=e[..., 0] * (0.5 + 0.2 * j),
                           rho=e[..., 1] * (1.7 + j), Q=0.3 + 0.1 * j)
    return k


def test_assoc_tier_float32_fleet_at_j8_is_quiet_on_card(cuda):
    """Float32 at J = 8 on the assoc tier, 64 chains of wide8 around
    theta = log[1, 5, 3] at N = 3e4 (chip_smoke.py's fleet of ROADMAP C5):
    every chain's value is finite, or -inf with zero gradients, never NaN,
    on the card and on the CPU's plain route for chains 0 and 48 (chain
    48's float32 z^2 / d overflows on the CPU)."""
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, 30_000))
    y = np.sin(0.7 * t) + 0.25 * rng.normal(size=30_000)
    noise = np.random.default_rng(17).normal(size=(64, 3))
    theta = np.log([1.0, 5.0, 3.0]) + 0.1 * noise
    prior = ct.get_config()
    results = []
    try:
        ct.set_config(backend="assoc")
        for device, chains in ((cuda, slice(None)), ("cpu", [0, 48])):
            th = torch.tensor(theta[chains], dtype=torch.float32, device=device,
                              requires_grad=True)
            ll = ct.gp_loglik(_wide8(th), torch.tensor(t, dtype=torch.float32,
                                                       device=device),
                              torch.tensor(y, dtype=torch.float32, device=device),
                              yerr=0.25)
            (g,) = torch.autograd.grad(ll.sum(), th)
            results.append((ll.detach().cpu(), g.cpu()))
    finally:
        ct.set_config(**prior.__dict__)
    for ll, g in results:
        quiet = ll == -np.inf
        assert (torch.isfinite(ll) | quiet).all()
        assert torch.isfinite(g).all() and (g[quiet] == 0).all()


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


# K15 and K16 at the probe's planes for these N (chip_smoke.py phase
# "layout"), and at general planes (E, TOT, LP, s): whole 32 x 32 tiles,
# and tiles cut at both edges
LAYOUT_SHAPES = [(layout_probe.E, g.TOT, g.LP, g.s) for g in map(
    layout_probe.SlabGeometry, (1, 8, 5000, 8192, 8193, 100_000, 1_000_000))] + [
    (3, 160, 96, 5), (3, 150, 70, 3)]


@pytest.mark.parametrize("E, TOT, LP, s", LAYOUT_SHAPES)
def test_layout_kernels_match_plain(cuda, E, TOT, LP, s):
    """K15 and K16 against their plain versions, exactly (a transpose moves
    bits), and the round trip against its input; one launch each."""
    x = torch.randn(E, TOT, LP, device=cuda, generator=torch.Generator(cuda).manual_seed(E + TOT))
    before = {k: _build.LAUNCHES[k] for k in ("slab_transpose", "slab_inverse")}
    y = _build.slab_transpose_cuda(x, s)
    z = _build.slab_inverse_cuda(y)
    torch.cuda.synchronize()
    assert torch.equal(y, layout.slab_transpose_plain(x, s))
    assert torch.equal(z, layout.slab_inverse_plain(y))
    assert torch.equal(z, x)
    assert {k: _build.LAUNCHES[k] - n for k, n in before.items()} == {
        "slab_transpose": 1, "slab_inverse": 1}


def test_layout_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        _build.slab_transpose_cuda(torch.zeros(4, 128, 128, dtype=torch.float64,
                                               device=cuda), 1)
    with pytest.raises(ValueError, match="contiguous"):
        _build.slab_transpose_cuda(torch.zeros(4, 128, 128, device=cuda).transpose(1, 2), 1)
    with pytest.raises(ValueError, match="split"):
        _build.slab_transpose_cuda(torch.zeros(4, 130, 128, device=cuda), 4)
