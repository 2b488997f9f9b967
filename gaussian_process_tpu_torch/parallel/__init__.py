"""Multi-device tier on ``torch.distributed`` (torch counterpart of
``parallel/``): the process mesh, sharded kernel blocks and the ring
matvec, distributed CG (ring matvec, sharded Nyström, segmented resume),
the panel-Cholesky exact posterior, sharded restarts and the distributed
training step.

The JAX package's distributed classifiers (``classification``,
``multiclass``), multi-host bring-up (``multihost``) and re-dispatch
(``recovery``) are not ported yet.
"""

from gaussian_process_tpu_torch.parallel.mesh import (
    gather_rows,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_rows,
)
from gaussian_process_tpu_torch.parallel.kernel_blocks import ring_matvec, sharded_gram
from gaussian_process_tpu_torch.parallel.cg import (
    ShardedCGState,
    distributed_posterior_cg,
    distributed_posterior_cg_segmented,
    distributed_posterior_mean_cg,
    make_posterior_cg,
    make_posterior_cg_segments,
    make_posterior_mean_cg,
)
from gaussian_process_tpu_torch.parallel.cholesky import (
    distributed_cholesky,
    distributed_cholesky_solve,
    distributed_posterior,
    make_distributed_posterior,
)
from gaussian_process_tpu_torch.parallel.restarts import (
    best_restart,
    make_sharded_gradient_restarts,
    make_sharded_lml,
    sharded_gradient_restarts,
    sharded_lml,
)
from gaussian_process_tpu_torch.parallel.train import TrainStepResult, make_distributed_train_step
from gaussian_process_tpu_torch.parallel import comm_model  # noqa: F401

__all__ = [
    "make_mesh",
    "shard_rows",
    "replicated",
    "pad_to_multiple",
    "gather_rows",
    "sharded_gram",
    "ring_matvec",
    "distributed_posterior_mean_cg",
    "make_posterior_mean_cg",
    "distributed_posterior_cg",
    "make_posterior_cg",
    "make_posterior_cg_segments",
    "distributed_posterior_cg_segmented",
    "ShardedCGState",
    "distributed_cholesky",
    "distributed_cholesky_solve",
    "make_distributed_posterior",
    "distributed_posterior",
    "sharded_lml",
    "make_sharded_lml",
    "sharded_gradient_restarts",
    "make_sharded_gradient_restarts",
    "best_restart",
    "make_distributed_train_step",
    "TrainStepResult",
    "comm_model",
]
