"""The samplers over groups of ranks: ``run_nuts(..., chain_group=)`` and
``run_smc(..., particle_group=)`` of celerite2_torch on gloo groups of 2
and 4 CPU ranks, held against their one-process runs.

The ranks are spawned once a group size (``tests/torch_dist_workers.py``
holds what they run: the port only) and save their results.  The
one-process runs are held against the JAX package elsewhere
(tests/test_torch_nuts.py, tests/test_torch_inference.py); here each rank's
chains or particles must be the one-process run's rows, at 1e-12, with
equal tree sizes and stages.  The statistical checks are
tests/test_sharding.py's (test_chain_sharded_nuts, test_particle_sharded_smc).
"""

import functools
import math

import numpy as np
import pytest
import torch

import celerite2_torch as ct
import torch_dist_workers as W
from celerite2_torch.inference import run_nuts, run_smc, split_rhat

ct.set_config(device="cpu")

WORLDS = (2, 4)
TIGHT = dict(rtol=1e-12, atol=1e-12)
PER_CHAIN = ("samples", "log_prob", "accept_prob", "num_steps", "diverging",
             "step_size", "inv_mass")


def _payload():
    rng = np.random.default_rng(99)
    t = np.sort(rng.uniform(0, 20, 64))
    yerr = np.full(64, 0.2)
    y = np.sin(0.8 * t) + yerr * rng.normal(size=64)
    return {"t": t, "y": y, "yerr": yerr}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world: [rank 0's results, rank 1's, ...]}``."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"groups{world}")
        out[world] = W.spawn(world, "group_checks", dict(_payload(), ckpt=str(tmp)), tmp)
    return out


@functools.lru_cache(maxsize=None)
def _gaussian_reference():
    res = run_nuts(W.gaussian_logp, torch.zeros(3, dtype=torch.float64),
                   torch.Generator().manual_seed(0), **W.GAUSSIAN_RUN)
    return W.fields(res)


@functools.lru_cache(maxsize=None)
def _gp_reference():
    res = run_nuts(W.gp_logpost(_payload()), torch.tensor(W.GP_NUTS_INIT, dtype=torch.float64),
                   torch.Generator().manual_seed(3), **W.GP_NUTS_RUN)
    return W.fields(res)


@functools.lru_cache(maxsize=None)
def _smc_reference():
    return W.fields(run_smc(*W.smc_toy(), torch.Generator().manual_seed(3), **W.SMC_RUN))


def _rows(world, rank, C):
    per = C // world
    return slice(rank * per, (rank + 1) * per)


def _hold_chains(got, want, rows):
    for field in PER_CHAIN:
        if field in ("num_steps", "diverging"):
            np.testing.assert_array_equal(got[field], want[field][rows], err_msg=field)
        else:
            np.testing.assert_allclose(got[field], want[field][rows], err_msg=field, **TIGHT)


@pytest.mark.parametrize("world", WORLDS)
def test_run_nuts_chain_group_matches_one_process(ranks, world):
    want = _gaussian_reference()
    for res in ranks[world]:
        _hold_chains(res["gaussian"], want, _rows(world, res["rank"], 8))


@pytest.mark.parametrize("world", WORLDS)
def test_run_nuts_chain_group_gaussian_statistics(ranks, world):
    """test_chain_sharded_nuts's checks on the fleet put back together:
    every split R-hat under 1.1 and the mean within 0.3 of [1, -1, 0]."""
    samples = np.concatenate([r["gaussian"]["samples"] for r in ranks[world]])
    assert samples.shape == (8, 300, 3)
    assert np.all(split_rhat(torch.from_numpy(samples)).numpy() < 1.1)
    np.testing.assert_allclose(samples.reshape(-1, 3).mean(0), [1.0, -1.0, 0.0], atol=0.3)


@pytest.mark.parametrize("world", WORLDS)
def test_run_nuts_chain_group_resumes_from_checkpoints(ranks, world):
    """A chunked GP run with a dense metric over the ranks, stopped after
    its second chunk with rank 0 a checkpoint behind, resumes where every
    rank can and ends as the one-process chunked run does."""
    want = _gp_reference()
    for res in ranks[world]:
        assert res["saved"] == ["step_0.pt", "step_1.pt"]
        _hold_chains(res["gp_resumed"], want, _rows(world, res["rank"], 8))
        assert res["gp_resumed"]["inv_mass"].shape == (8 // world, 3, 3)


@pytest.mark.parametrize("world", WORLDS)
def test_groups_refuse_retries_and_uneven_splits(ranks, world):
    for res in ranks[world]:
        assert res["refused"] == {"on_retry": True, "chains": True, "particles": True}


@pytest.mark.parametrize("world", WORLDS)
def test_run_smc_particle_group_matches_one_process(ranks, world):
    want = _smc_reference()
    for res in ranks[world]:
        got = res["smc"]
        assert int(got["n_stages"]) == int(want["n_stages"])
        for field in ("log_evidence", "final_beta", "mutation_eps"):
            np.testing.assert_allclose(got[field], want[field], err_msg=field, **TIGHT)
        np.testing.assert_allclose(got["particles"],
                                   want["particles"][_rows(world, res["rank"], 512)],
                                   **TIGHT)


@pytest.mark.parametrize("world", WORLDS)
def test_run_smc_particle_group_evidence_closed_form(ranks, world):
    """The toy's evidence is (pi / 2) N(mu; 0, 9.25 I): the prior N(0, 9 I)
    against an unnormalised Gaussian likelihood of variance 0.25.  One
    run's estimate at 512 particles spreads by 0.10 (20 seeds, one
    process), so the mean of 16 runs over the group (seeds 0 to 15) is
    held within 0.1, four of its standard errors, and each run within
    0.4."""
    mu = np.array([0.5, -0.25])
    want = math.log(math.pi / 2) - math.log(2 * math.pi * 9.25) - 0.5 * mu @ mu / 9.25
    for res in ranks[world]:
        assert float(res["smc"]["final_beta"]) == 1.0
        errs = np.array(res["evidence"]) - want
        assert len(errs) == 16
        assert abs(errs.mean()) < 0.1, errs
        assert np.abs(errs).max() < 0.4, errs
