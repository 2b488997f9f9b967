"""LML hyperparameter tuning by gradient ascent (torch counterpart of
``opt/gradient.py``).

The JAX package differentiates the log marginal likelihood with
``jax.grad`` inside one compiled ``lax.while_loop``; here autograd runs
through the same LML in a Python loop with ``torch.optim``. ``Adam``'s
defaults (betas 0.9 / 0.999, eps 1e-8 added to the bias-corrected root) and
``SGD`` are the update rules of ``optax.adam`` and ``optax.sgd``, so float64
trajectories follow the JAX package's closely. The loop reads the LML on
the host once per iteration to test the stop criterion.

Stop criterion and defaults mirror the reference: lr = 0.01
[ref: tune_hyperparms_regression.py:63], tol = 1e-3 on |delta LML|
[ref: :117], at most 10000 iterations [ref: :121].
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.ops import kernels as _k


def log_params(params):
    """Map positive params to unconstrained log-space."""
    return _k.tree_map_params(torch.log, params)


def exp_params(params):
    return _k.tree_map_params(torch.exp, params)


def _transforms(transform: str):
    if transform == "log":
        return log_params, exp_params
    if transform == "none":
        return (lambda p: p), (lambda p: p)
    raise ValueError(f"unknown transform {transform!r}")


def make_optimizer(name: str, leaves, learning_rate: float) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` (``optax.adam``'s rule) for "adam", plain
    ``SGD`` (``optax.sgd``) otherwise, as the JAX package dispatches."""
    if name == "adam":
        return torch.optim.Adam(leaves, lr=learning_rate)
    return torch.optim.SGD(leaves, lr=learning_rate)


def trainable_leaves(params: _k.Params, transform):
    """Fresh leaf tensors of ``transform(params)`` that require grad."""
    return [leaf.detach().clone().requires_grad_(True)
            for leaf in _k.tree_leaves(transform(params))]


class GradientResult(NamedTuple):
    params: Any  # optimised hyperparameters (original space), detached
    lml: torch.Tensor  # final log marginal likelihood
    iters: int  # iterations actually run
    converged: bool
    lml_trace: torch.Tensor  # (max_iters,) LML per iteration, NaN-padded


def tune_gradient_ascent(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    noise_variance: float = 5e-4,
    learning_rate: Optional[float] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    optimizer: Optional[str] = None,
    trainable: Optional[Any] = None,
    transform: str = "none",
    dist_method: str = "dot",
    cfg: Optional[_config.GradientAscentConfig] = None,
) -> GradientResult:
    """Maximise the LML over ``params`` by autograd and ``torch.optim``.

    ``cfg`` supplies learning_rate / tol / max_iters / optimizer defaults;
    explicit arguments win. ``trainable``: a tree of bools matching
    ``params``; frozen leaves get zero gradient (the reference fixes sigma
    and trains only the lengthscale [ref: tune_hyperparms_regression.py:46-52]).
    ``transform="log"`` optimises log-params for positivity; ``"none"``
    reproduces the reference's raw-space ascent. Iterates while
    |LML_i - LML_{i-1}| > tol, at most ``max_iters`` times.
    """
    base = _config.DEFAULT_GA if cfg is None else cfg
    learning_rate = base.learning_rate if learning_rate is None else learning_rate
    tol = base.tol if tol is None else tol
    max_iters = base.max_iters if max_iters is None else max_iters
    optimizer = base.optimizer if optimizer is None else optimizer
    to_opt, from_opt = _transforms(transform)
    params = _k.tree_map_params(lambda a: torch.as_tensor(a, device=x_train.device), params)
    mask = (_k.tree_leaves(trainable) if trainable is not None
            else [True] * len(_k.tree_leaves(params)))

    def objective(leaves):
        return _reg.log_marginal_likelihood(
            kernel, from_opt(_k.tree_unflatten(params, leaves)), x_train, y_train,
            noise_variance=noise_variance, dist_method=dist_method,
        )

    leaves = trainable_leaves(params, to_opt)
    opt = make_optimizer(optimizer, leaves, learning_rate)
    dtype = torch.promote_types(y_train.dtype, torch.get_default_dtype())
    trace = torch.full((max_iters,), float("nan"), dtype=dtype)
    prev, cur = math.inf, -math.inf
    i = 0
    while i < max_iters and (abs(cur - prev) > tol or i == 0):
        opt.zero_grad()
        lml = objective(leaves)
        (-lml).backward()  # ascend: the optimizer minimises
        for leaf, train in zip(leaves, mask):
            if not train:
                leaf.grad.zero_()
        opt.step()
        prev, cur = cur, float(lml.detach())
        trace[i] = cur
        i += 1

    final = from_opt(_k.tree_unflatten(params, [leaf.detach() for leaf in leaves]))
    with torch.no_grad():
        final_lml = _reg.log_marginal_likelihood(
            kernel, final, x_train, y_train,
            noise_variance=noise_variance, dist_method=dist_method,
        )
    return GradientResult(params=final, lml=final_lml, iters=i,
                          converged=abs(cur - prev) <= tol, lml_trace=trace)
