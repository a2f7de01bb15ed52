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
