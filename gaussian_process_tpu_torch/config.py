"""Frozen configuration dataclasses.

Plain dataclasses carried over from the JAX package's ``config.py``
(``SolveConfig``) with the same field names and defaults, so a config built
for one package means the same thing in the other. Only the fields the
regression serving path reads are here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Linear-algebra behaviour for GP solves."""

    noise_variance: float = 5e-4  # observation noise s [ref: GP_regression.py:120]
    sampling_jitter: float = 1e-6  # posterior-sample jitter [ref: GP_regression.py:154]
    max_chol_attempts: int = 8  # jitter-escalation retries on non-PSD K
    jitter_growth: float = 10.0
    # Conjugate-gradient settings (large-n path). Tolerances below 1e-5
    # switch the fused matvec to its "highest" output dot (gp.posterior_cg);
    # the CUDA kernel runs full fp32 FMAs in both modes.
    cg_tol: float = 1e-6
    cg_max_iters: int = 1000
    cg_precondition: bool = True


DEFAULT_SOLVE = SolveConfig()
