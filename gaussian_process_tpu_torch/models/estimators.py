"""Estimator facade: ``GPRegressor`` (torch counterpart of the regression
estimator in ``models/estimators.py``).

``fit`` stores tensors on the estimator's device; every compute path
delegates to the functions in ``gp``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gaussian_process_tpu_torch import convert as _convert
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.opt import gradient as _grad


class GPRegressor:
    """Exact GP regression (R&W Alg. 2.1) with optional LML hyperparameter
    optimisation by autograd, and a matrix-free solver for large n.

    >>> model = GPRegressor(ops.RBF(), noise_variance=5e-4, device="cuda")
    >>> model.fit(x_train, y_train, optimize=True)
    >>> mean, std = model.predict(x_test, return_std=True)

    ``device``: where the training data, the params and the computation
    live (None: the device of the data given to ``fit``).
    """

    def __init__(
        self,
        kernel: _k.Kernel,
        params: Optional[_k.Params] = None,
        *,
        noise_variance: float = 5e-4,
        dist_method: str = "dot",
        device: Union[str, torch.device, None] = None,
    ):
        self.kernel = kernel
        self.params = kernel.init_params() if params is None else params
        self.noise_variance = float(noise_variance)
        self.dist_method = dist_method
        self.device = None if device is None else torch.device(device)
        self.x_train = None
        self.y_train = None
        self.lml_ = None

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def fit(
        self,
        x,
        y,
        *,
        optimize: bool = False,
        learning_rate: float = 0.01,
        max_iters: int = 1000,
        optimizer: str = "adam",
        transform: str = "log",
        trainable=None,
    ) -> "GPRegressor":
        """Store the training set; optionally maximise the LML over the
        kernel hyperparameters (``opt.tune_gradient_ascent``). The params
        kept are detached tensors."""
        self.x_train = self._to_device(x)
        self.y_train = self._to_device(y)
        self.device = self.x_train.device
        self.params = _convert.params_from_numpy(self.params, device=self.device)
        if optimize:
            res = _grad.tune_gradient_ascent(
                self.kernel,
                self.params,
                self.x_train,
                self.y_train,
                noise_variance=self.noise_variance,
                learning_rate=learning_rate,
                max_iters=max_iters,
                optimizer=optimizer,
                transform=transform,
                trainable=trainable,
                dist_method=self.dist_method,
            )
            self.params = res.params
            self.lml_ = res.lml
        else:
            self.lml_ = _reg.log_marginal_likelihood(
                self.kernel,
                self.params,
                self.x_train,
                self.y_train,
                noise_variance=self.noise_variance,
                dist_method=self.dist_method,
            )
        return self

    def _check_fitted(self):
        if self.x_train is None:
            raise RuntimeError("call fit() first")

    def posterior(self, x_test) -> _reg.Posterior:
        self._check_fitted()
        return _reg.posterior(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            self._to_device(x_test),
            noise_variance=self.noise_variance,
            dist_method=self.dist_method,
        )

    def posterior_cg(self, x_test, **kwargs) -> _reg.CGPosterior:
        """Matrix-free posterior (mean and variance); see
        ``gp.posterior_cg`` for the keyword arguments."""
        self._check_fitted()
        return _reg.posterior_cg(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            self._to_device(x_test),
            noise_variance=self.noise_variance,
            **kwargs,
        )

    def predict(self, x_test, *, return_std: bool = False, solver: str = "auto"):
        """solver: "cholesky" (exact dense), "cg" (matrix-free), or "auto":
        CG once n_train exceeds 32768."""
        self._check_fitted()
        if solver == "auto":
            solver = "cg" if self.x_train.shape[0] > 32768 else "cholesky"
        if solver == "cg":
            post = self.posterior_cg(x_test)
        elif solver == "cholesky":
            post = self.posterior(x_test)
        else:
            raise ValueError(f"unknown solver {solver!r}")
        return (post.mean, post.std) if return_std else post.mean

    def sample(
        self,
        x_test,
        generator: Optional[torch.Generator] = None,
        *,
        num_functions: int = 10,
    ) -> torch.Tensor:
        """Joint posterior draws at ``x_test``."""
        x_test = self._to_device(x_test)
        post = self.posterior(x_test)
        return _reg.sample_posterior(
            self.kernel,
            self.params,
            post,
            x_test,
            generator,
            num_functions=num_functions,
            dist_method=self.dist_method,
        )

    def log_marginal_likelihood(self) -> torch.Tensor:
        self._check_fitted()
        return self.lml_
