"""Frozen configuration dataclasses.

Plain dataclasses carried over from the JAX package's ``config.py``
(``SolveConfig``, ``NewtonConfig``, ``GradientAscentConfig``) with the same
field names and defaults, so a config built for one package means the same
thing in the other. Only the configs of the ported paths are here.
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
    # Conjugate-gradient settings (large-n path). As in the JAX package, a
    # tolerance below 1e-5 hands the fused matvec dot_mode "highest", 1e-5
    # and above "split3" (gp.regression.cg_dot_mode). On the card both
    # modes take the same products (ops.cuda.kernel_ops.gram_matvec): the
    # full sweep's 3xTF32 is more precise than fp32 FMAs.
    cg_tol: float = 1e-6
    cg_max_iters: int = 1000
    cg_precondition: bool = True


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Laplace-approximation Newton iteration (``gp.classification``,
    ``gp.multiclass``). The reference caps iterations at 10000 with tol 1e-4
    (binary) [ref: GP_binary_classification.py:98,114]; true Newton needs
    far fewer."""

    tol: float = 1e-6
    max_iters: int = 100
    damping: float = 0.0  # the reference's damped multi-class trainer (unused by Newton)


@dataclasses.dataclass(frozen=True)
class GradientAscentConfig:
    """LML gradient-based hyperparameter optimisation (``opt.gradient``)."""

    learning_rate: float = 0.01  # [ref: tune_hyperparms_regression.py:63]
    tol: float = 1e-3  # |delta LML| stop criterion [ref: tune_hyperparms_regression.py:117]
    max_iters: int = 10000  # [ref: tune_hyperparms_regression.py:121]
    optimizer: str = "sgd"  # "sgd" reproduces the reference's ascent; "adam" for production


DEFAULT_SOLVE = SolveConfig()
DEFAULT_NEWTON = NewtonConfig()
DEFAULT_GA = GradientAscentConfig()
