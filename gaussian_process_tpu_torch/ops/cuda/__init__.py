"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use."""

from gaussian_process_tpu_torch.ops.cuda.chol import chol_inv_panel, chol_inv_panel_reference
from gaussian_process_tpu_torch.ops.cuda.kernel_ops import (
    gram,
    gram_ad,
    gram_matvec,
    gram_matvec_reference,
    gram_matvec_vjp_reference,
    gram_reference,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "chol_inv_panel",
    "chol_inv_panel_reference",
    "gram",
    "gram_ad",
    "gram_matvec",
    "gram_matvec_reference",
    "gram_matvec_vjp_reference",
    "gram_reference",
    "launch_counts",
    "reset_launch_counts",
]
