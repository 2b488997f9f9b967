"""Hyperparameter optimisation: LML gradient ascent, exact and matrix-free."""

from gaussian_process_tpu_torch.opt.gradient import (
    GradientResult,
    exp_params,
    log_params,
    tune_gradient_ascent,
)
from gaussian_process_tpu_torch.opt.large_scale import (
    LargeScaleResult,
    lml_estimate,
    lml_surrogate,
    slq_logdet,
    slq_logdet_matvec,
    tune_large_scale,
)

__all__ = [
    "GradientResult",
    "tune_gradient_ascent",
    "log_params",
    "exp_params",
    "LargeScaleResult",
    "lml_surrogate",
    "tune_large_scale",
    "slq_logdet",
    "slq_logdet_matvec",
    "lml_estimate",
]
