"""Kernel-matrix primitives: distances, the kernel algebra, and the CUDA
tile gram and matvec (``ops.cuda``)."""

from gaussian_process_tpu_torch.ops.distance import sqdist, absdist
from gaussian_process_tpu_torch.ops.kernels import (
    RBF,
    Linear,
    Matern,
    Periodic,
    DecayedPeriodic,
    RationalQuadratic,
    White,
    Sum,
    Product,
    Scaled,
    gram,
    gram_diag,
    co2_kernel,
    co2_params_from_vector,
    co2_vector_from_params,
)
from gaussian_process_tpu_torch.ops import cuda  # noqa: F401

__all__ = [
    "sqdist",
    "absdist",
    "RBF",
    "Linear",
    "Matern",
    "Periodic",
    "DecayedPeriodic",
    "RationalQuadratic",
    "White",
    "Sum",
    "Product",
    "Scaled",
    "gram",
    "gram_diag",
    "co2_kernel",
    "co2_params_from_vector",
    "co2_vector_from_params",
]
