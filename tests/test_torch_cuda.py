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
}
KERNEL = {
    "kalman_fwd": _build.kalman_fwd_cuda,
    "solve_rev": _build.solve_rev_cuda,
    "factor_rev": _build.factor_rev_cuda,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _system(N, C, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.tensor(np.sort(rng.uniform(0, 10, N)), dtype=torch.float64)
    sigma = torch.tensor(rng.uniform(0.8, 1.5, C), dtype=torch.float64)
    kernel = ct.SHOTerm(sigma=sigma, rho=3.4, tau=2.9)
    c, a, U, V = kernel.get_celerite_matrices(t, 0.04)
    y = torch.tensor(np.sin(t.numpy()) + 0.2 * rng.normal(size=(C, N)))
    return t, c, a, U, V, y


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_kernel_matches_plain(cuda, name):
    """N = 300 in blocks of 16 (a ragged last block), C = 3, float64."""
    args = [x.to(cuda) for x in _system(300, 3)]
    inputs = fl.pass_inputs(*args, block_len=16)[name]
    before = _build.LAUNCHES[name]
    pre_k, maps_k = KERNEL[name](*inputs, 16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    pre_p, maps_p = PLAIN[name](*inputs, 16)
    for got, want in ((pre_k, pre_p), (maps_k, maps_p)):
        scale = want.abs().max()
        assert ((got - want).abs().max() / scale).item() < 1e-10


def test_gp_loglik_cuda_matches_cpu(cuda):
    t, c, a, U, V, y = _system(2000, 2)
    th = torch.tensor([0.1, 1.2, 1.0], dtype=torch.float64)

    def value_grad(device):
        th_d = th.to(device).requires_grad_(True)
        kernel = ct.SHOTerm(sigma=th_d[0].exp(), rho=th_d[1].exp(),
                            tau=th_d[2].exp())
        ll = ct.gp_loglik(kernel, t.to(device), y[0].to(device), yerr=0.2)
        (g,) = torch.autograd.grad(ll, th_d)
        return ll.item(), g.cpu()

    v0, g0 = value_grad(torch.device("cpu"))
    v1, g1 = value_grad(cuda)
    np.testing.assert_allclose(v1, v0, rtol=1e-10)
    torch.testing.assert_close(g1, g0, rtol=1e-9, atol=1e-9 * g0.abs().max())
