"""Inference: the fleet sampler, MAP, ADVI, SMC, diagnostics and
checkpoints.

Counterpart of ``celerite2_tpu.inference``, with one contract of its own:
every log-density here is **batched**, ``logdensity_fn(q (C, dim)) ->
(C,)``, where the JAX package vmaps a scalar one (see ``hmc``).  Draws
come from a ``torch.Generator`` in place of a JAX key.  NUTS runs the
fleet's chains together (``nuts_kernel``, ``build_nuts_step``) with
per-chain windowed adaptation (``run_nuts``, ``warmup_and_sample``).
"""

from celerite2_torch.inference.checkpoint import (
    CheckpointManager,
    restore_state,
    save_state,
)
from celerite2_torch.inference.diagnostics import (
    effective_sample_size,
    split_rhat,
    summary,
)
from celerite2_torch.inference.fit import MAPResult, fit_map
from celerite2_torch.inference.hmc import HMCResult, run_hmc
from celerite2_torch.inference.nuts import NUTSInfo, build_nuts_step, nuts_kernel
from celerite2_torch.inference.sampler import NUTSResult, run_nuts, warmup_and_sample
from celerite2_torch.inference.smc import SMCResult, run_smc
from celerite2_torch.inference.transforms import (
    IdentityTransform,
    LogTransform,
    transform_logdensity,
)
from celerite2_torch.inference.vi import ADVIResult, run_advi

__all__ = [
    "fit_map",
    "MAPResult",
    "save_state",
    "restore_state",
    "CheckpointManager",
    "run_hmc",
    "HMCResult",
    "run_nuts",
    "NUTSResult",
    "NUTSInfo",
    "nuts_kernel",
    "build_nuts_step",
    "warmup_and_sample",
    "run_advi",
    "ADVIResult",
    "run_smc",
    "SMCResult",
    "split_rhat",
    "effective_sample_size",
    "summary",
    "LogTransform",
    "IdentityTransform",
    "transform_logdensity",
]
