"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use."""

from gaussian_process_tpu_torch.ops.cuda.kernel_ops import (
    gram_matvec,
    gram_matvec_reference,
    gram_matvec_vjp_reference,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "gram_matvec",
    "gram_matvec_reference",
    "gram_matvec_vjp_reference",
    "launch_counts",
    "reset_launch_counts",
]
