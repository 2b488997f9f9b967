"""Multi-device tier on ``torch.distributed`` (torch counterpart of
``parallel/``): the process mesh, sharded kernel blocks and the ring
matvec, distributed CG (ring matvec, sharded Nyström, segmented resume),
the panel-Cholesky exact posterior, sharded restarts, the distributed
training step, the distributed binary Laplace classifier (Newton over the
ring), the class-sharded multi-class Newton, multi-host bring-up
(``multihost``) and the re-dispatch of lost candidates (``recovery``).
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
from gaussian_process_tpu_torch.parallel.classification import (
    distributed_fit_predict_binary,
    make_laplace_fit as make_distributed_laplace_fit,
    make_laplace_predict as make_distributed_laplace_predict,
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
from gaussian_process_tpu_torch.parallel.multiclass import (
    fit_multiclass_sharded,
    make_sharded_multiclass_fit,
)
from gaussian_process_tpu_torch.parallel.recovery import RedispatchResult, run_with_redispatch
from gaussian_process_tpu_torch.parallel.train import TrainStepResult, make_distributed_train_step
from gaussian_process_tpu_torch.parallel import comm_model  # noqa: F401
from gaussian_process_tpu_torch.parallel import multihost

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
    "make_distributed_laplace_fit",
    "make_distributed_laplace_predict",
    "distributed_fit_predict_binary",
    "distributed_cholesky",
    "distributed_cholesky_solve",
    "make_distributed_posterior",
    "distributed_posterior",
    "sharded_lml",
    "make_sharded_lml",
    "sharded_gradient_restarts",
    "make_sharded_gradient_restarts",
    "best_restart",
    "fit_multiclass_sharded",
    "make_sharded_multiclass_fit",
    "run_with_redispatch",
    "RedispatchResult",
    "multihost",
    "make_distributed_train_step",
    "TrainStepResult",
    "comm_model",
]
