"""Frozen configuration dataclasses.

Plain dataclasses carried over from the JAX package's ``config.py``
(``SolveConfig``, ``NewtonConfig``, ``GradientAscentConfig``, ``BOConfig``,
``MeshConfig``) with the same field names and defaults, so a config built
for one package means the same thing in the other. ``BenchConfig`` waits
for the port's bench harness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """Bayesian-optimisation hyperparameter search (``opt.bo``).

    [ref: tune_hyperparms_regression.py:349-395 (1-D, n_iterations=3),
    CO2_example.py:330-379 (11-D, 10 iters x 500 candidates)]
    """

    n_iterations: int = 3
    n_candidates: int = 100
    surrogate_noise: float = 1e-4  # [ref: tune_hyperparms_regression.py:75]
    acquisition: str = "PI"  # "PI" | "EI" | "UCB" | "TS"
    ucb_kappa: float = 0.001  # [ref: tune_hyperparms_regression.py:219]
    pi_early_stop: float = 1e-3  # PI stops when max CDF <= this [ref: :183-188]
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout for the multi-device tier (``parallel``).

    Axes: ``data`` shards kernel-matrix block-rows over ranks; ``restart``
    shards independent hyperparameter restarts. ``parallel.make_mesh`` reads
    the sizes; a rank is one process of ``torch.distributed``.
    """

    data_axis: str = "data"
    restart_axis: str = "restart"
    data_axis_size: Optional[int] = None  # None -> all ranks on the data axis
    restart_axis_size: int = 1


DEFAULT_SOLVE = SolveConfig()
DEFAULT_NEWTON = NewtonConfig()
DEFAULT_GA = GradientAscentConfig()
DEFAULT_BO = BOConfig()
DEFAULT_MESH = MeshConfig()
