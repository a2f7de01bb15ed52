"""A dry run of the multi-rank training paths.

Counterpart of ``__graft_entry__.dryrun_multichip``: on the ranks of the
default process group (which the caller has joined, for example with
``initialize_distributed``), it factors the ranks into a ``(chains, seq)``
mesh and runs, at small sizes,

1. the HMC step with the chains over ``chains`` and the sequence-sharded
   log-likelihood over ``seq`` (``make_hmc_train_step``);
2. the adaptive fleet sampler ``run_hmc`` with its chains over every rank
   (the cross-chain means of its adaptation are sums over the ranks);
3. with ``seq`` > 1, a posterior-predictive draw of the sequence-sharded
   pathwise sampler over a ``(1, ranks)`` mesh.

Each part checks shapes and finite values; the function returns what it
checked.  A user's sanity check of a multi-rank launch, and what
``chip_smoke.py`` runs on its ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from celerite2_torch import gp_loglik
from celerite2_torch.inference import run_hmc
from celerite2_torch.models.terms import SHOTerm
from celerite2_torch.parallel.mesh import make_mesh
from celerite2_torch.parallel.sharded import make_sharded_conditional_sampler
from celerite2_torch.parallel.train_step import make_hmc_train_step

__all__ = ["dryrun_multichip"]


def _data(n):
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 100, n))
    return t, np.full(n, 0.25), np.sin(0.7 * t) + 0.25 * rng.normal(size=n)


def _builder(theta):
    e = theta.exp()
    return SHOTerm(sigma=e[..., 0], rho=e[..., 1], tau=e[..., 2])


def dryrun_multichip(device=None) -> dict:
    """Run parts 1 to 3 (the module docstring) on every rank of the default
    group, on ``device`` (default: the package's ``Config.device``)."""
    n_ranks = dist.get_world_size()
    seq = next((s for s in (4, 2) if n_ranks % s == 0), 1)
    chains = n_ranks // seq
    mesh = make_mesh(chains=chains, seq=seq)
    t, yerr, y = _data(16 * seq)
    gen = torch.Generator().manual_seed(0)

    # 1: the fixed-length HMC step, chains x seq
    step_fn, init_fn = make_hmc_train_step(_builder, t, y, yerr, mesh, step_size=0.01,
                                           num_leapfrog=2, device=device)
    num_chains = 2 * chains
    qs = init_fn(num_chains, 3, gen)
    qs2, accept = step_fn(qs, gen)
    assert qs2.shape == (2, 3) and bool(torch.isfinite(qs2).all())
    assert accept.shape == (2,)

    # 2: the adaptive fleet over every rank
    tt = torch.as_tensor(t, dtype=torch.float64, device=qs.device)
    yy = torch.as_tensor(y, dtype=torch.float64, device=qs.device)

    def logpost(theta):
        ll = gp_loglik(_builder(theta), tt, yy, yerr=0.25)
        return ll - 0.5 * ((theta / 3.0) ** 2).sum(-1)

    res = run_hmc(logpost, torch.log(torch.tensor([1.0, 5.0, 3.0], dtype=torch.float64,
                                                   device=qs.device)),
                  torch.Generator(qs.device).manual_seed(1), num_warmup=4,
                  num_samples=4, num_chains=2 * n_ranks, max_leapfrog=4,
                  chain_group=dist.group.WORLD)
    assert res.samples.shape == (2, 4, 3) and bool(torch.isfinite(res.samples).all())
    out = {"mesh": (chains, seq), "step": tuple(qs2.shape),
           "hmc": tuple(res.samples.shape)}

    # 3: the sequence-sharded posterior-predictive draw
    if seq > 1:
        seq_mesh = make_mesh(chains=1, seq=n_ranks)
        t2, yerr2, y2 = _data(16 * n_ranks)
        kernel = _builder(torch.log(torch.tensor([1.0, 5.0, 3.0], dtype=torch.float64,
                                                 device=qs.device)))
        sample = make_sharded_conditional_sampler(
            kernel, t2, y2, yerr2, np.linspace(5.0, 95.0, 7), seq_mesh, device=device)
        draw = sample(torch.Generator().manual_seed(2))
        assert draw.shape == (7,) and bool(torch.isfinite(draw).all())
        out["draw"] = tuple(draw.shape)
    return out
