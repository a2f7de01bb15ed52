"""The sharded paths on ``torch.distributed``: the sequence split over the
ranks of a ``seq`` group, the chains over a ``chains`` group.

Counterpart of ``celerite2_tpu/parallel`` (its ``PartitionSpec`` ``P`` has
no counterpart here: see ``mesh.py``).  ``comm.py`` holds the collectives
that take the place of ``lax.ppermute``, ``all_gather`` and ``psum``, and
``dryrun.py`` the counterpart of ``__graft_entry__.dryrun_multichip``.
"""

from celerite2_torch.parallel.mesh import (
    Mesh,
    chain_sharding,
    initialize_distributed,
    make_mesh,
    seq_sharding,
)
from celerite2_torch.parallel.sharded import (
    make_sharded_conditional_sampler,
    make_sharded_logdensity,
    sharded_apply_inverse,
    sharded_conditional_covariance,
    sharded_conditional_variance,
    sharded_dot_tril,
    sharded_factor,
    sharded_general_matmul_lower,
    sharded_general_matmul_upper,
    sharded_loglik,
    sharded_matmul_lower,
    sharded_matmul_upper,
    sharded_predict_mean,
    sharded_predict_mean_at,
    sharded_sample_conditional,
    sharded_solve_lower,
    sharded_solve_upper,
)
from celerite2_torch.parallel.train_step import make_hmc_train_step

__all__ = [
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "chain_sharding",
    "seq_sharding",
    "sharded_loglik",
    "sharded_factor",
    "sharded_solve_lower",
    "sharded_solve_upper",
    "sharded_matmul_lower",
    "sharded_matmul_upper",
    "sharded_apply_inverse",
    "sharded_dot_tril",
    "sharded_predict_mean",
    "sharded_predict_mean_at",
    "sharded_general_matmul_lower",
    "sharded_general_matmul_upper",
    "sharded_conditional_variance",
    "sharded_conditional_covariance",
    "make_sharded_logdensity",
    "sharded_sample_conditional",
    "make_sharded_conditional_sampler",
    "make_hmc_train_step",
]
