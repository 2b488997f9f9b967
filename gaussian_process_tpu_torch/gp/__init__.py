"""GP inference: exact and matrix-free regression."""

from gaussian_process_tpu_torch.gp.regression import (
    CGPosterior,
    Posterior,
    log_marginal_likelihood,
    posterior,
    posterior_cg,
    posterior_mean_cg,
    sample_posterior,
    sample_prior,
)

__all__ = [
    "CGPosterior",
    "Posterior",
    "log_marginal_likelihood",
    "posterior",
    "posterior_cg",
    "posterior_mean_cg",
    "sample_posterior",
    "sample_prior",
]
