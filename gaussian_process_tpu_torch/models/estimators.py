"""Estimator facade: ``GPRegressor``, ``GPBinaryClassifier`` and
``GPMulticlassClassifier`` (torch counterparts of ``models/estimators.py``).

``fit`` stores tensors on the estimator's device, the card unless the
caller asks for another (``device="cpu"``); every compute path delegates to
the functions in ``gp``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gaussian_process_tpu_torch import convert as _convert
from gaussian_process_tpu_torch.gp import classification as _cls
from gaussian_process_tpu_torch.gp import multiclass as _mc
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.gp import whitened as _wh
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.opt import gradient as _grad


def _resolve_device(device) -> torch.device:
    """The estimators' device: the card (``torch.device("cuda")``) unless
    the caller names another."""
    return torch.device("cuda") if device is None else torch.device(device)


def _as_tensor(x, device: torch.device, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` on ``device``. A tensor keeps its dtype. Anything else (a NumPy
    array, a list) keeps an integer type (class labels), and floating
    values take ``like``'s dtype where given (test points and targets
    follow the training points), else ``torch.get_default_dtype()``: fp32
    unless the caller changed it, as ``jnp.asarray`` gives fp32 without x64.
    So NumPy float64 data reaches the fp32 CUDA kernels, not the plain
    float64 path."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.as_tensor(np.asarray(x))
    if t.is_floating_point():
        floating = like is not None and like.is_floating_point()
        t = t.to(like.dtype if floating else torch.get_default_dtype())
    return t.to(device)


def _check_device(device: torch.device) -> None:
    """Refuse to fit on the card where there is none, rather than carry on
    on the CPU."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the estimator's device is the GPU (device=None means cuda), but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )


class GPRegressor:
    """Exact GP regression (R&W Alg. 2.1) with optional LML hyperparameter
    optimisation by autograd, and a matrix-free solver for large n.

    >>> model = GPRegressor(ops.RBF(), noise_variance=5e-4, device="cuda")
    >>> model.fit(x_train, y_train, optimize=True)
    >>> mean, std = model.predict(x_test, return_std=True)

    ``device``: where the training data, the params and the computation
    live (None: the card, ``torch.device("cuda")``; ``"cpu"`` for the CPU).
    ``fit`` moves the data there, whatever device it arrives on, and raises
    where the device is the card and CUDA is absent.
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
        self.device = _resolve_device(device)
        self.x_train = None
        self.y_train = None
        self.lml_ = None

    def _to_device(self, x) -> torch.Tensor:
        return _as_tensor(x, self.device, like=self.x_train)

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
        _check_device(self.device)
        self.x_train = _as_tensor(x, self.device)
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

    def posterior_whitened(self, x_test, *, dtype: torch.dtype = torch.float32
                           ) -> _wh.WhitenedPosterior:
        """The whitened posterior (``gp.whitened_posterior``) on the
        estimator's device: inputs centred and targets standardised by an
        exact reparameterisation, the fp32 path for ill-conditioned data
        such as year-valued CO2 inputs with book-scale amplitudes.
        Stationary kernels only."""
        self._check_fitted()
        return _wh.whitened_posterior(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            x_test,
            noise_variance=self.noise_variance,
            dtype=dtype,
            device=self.device,
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


# the training-set size above which solver="auto" picks the matrix-free path
AUTO_CG_N = 32768


class _Classifier:
    """What both classifiers share: the device, the fit's solver choice and
    the accuracy score."""

    def __init__(self, kernel, params, dist_method, device):
        self.kernel = kernel
        self.params = kernel.init_params() if params is None else params
        self.dist_method = dist_method
        self.device = _resolve_device(device)
        self.x_train = None
        self.state = None
        self._solver = None

    def _to_device(self, x) -> torch.Tensor:
        return _as_tensor(x, self.device, like=self.x_train)

    def _store(self, x, solver: str, cg_tol, cg_max_iters):
        """Keep the training points and their params on the device; the
        solver "auto" resolves to "cg" above ``AUTO_CG_N`` points. Returns
        the solver and the CG options of the matrix-free fit, defaults
        filled in (tolerance 1e-6, cap 200); the Cholesky route runs no CG,
        so it refuses either option rather than drop it, before anything
        is stored."""
        if solver not in ("auto", "cg", "cholesky"):
            raise ValueError(f"unknown solver {solver!r}")
        _check_device(self.device)
        x_train = _as_tensor(x, self.device)
        if solver == "auto":
            solver = "cg" if x_train.shape[0] > AUTO_CG_N else "cholesky"
        if solver == "cg":
            cg_args = {"cg_tol": 1e-6 if cg_tol is None else cg_tol,
                       "cg_max_iters": 200 if cg_max_iters is None else cg_max_iters}
        elif cg_tol is not None or cg_max_iters is not None:
            raise ValueError(
                "cg_tol and cg_max_iters set the matrix-free fit's CG; the Cholesky route "
                f"(solver='cholesky', or 'auto' up to n = {AUTO_CG_N}) runs no CG")
        else:
            cg_args = {}
        self.x_train = x_train
        self.device = self.x_train.device
        self.params = _convert.params_from_numpy(self.params, device=self.device)
        self._solver = solver
        return solver, cg_args

    def _check_fitted(self):
        if self.state is None:
            raise RuntimeError("call fit() first")

    def score(self, x_test, y_test) -> float:
        """Accuracy: the reference's printed metric
        [ref: GP_binary_classification.py:241, GP_multi_classification.py:253]."""
        labels = self.predict(x_test)
        y_test = torch.as_tensor(y_test, device=labels.device)
        return float(torch.mean((labels == y_test).double()))


class GPBinaryClassifier(_Classifier):
    """Laplace-approximation binary GP classification (labels in {-1, +1}),
    true Newton at the current iterate (the reference freezes W and the
    gradient at the prior sample, quirk Q2
    [ref: GP_binary_classification.py:104-105]).

    ``device``: where the training data, the params and the computation
    live (None: the card; ``"cpu"`` for the CPU), as for ``GPRegressor``.
    """

    def __init__(
        self,
        kernel: _k.Kernel,
        params: Optional[_k.Params] = None,
        *,
        dist_method: str = "dot",
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(kernel, params, dist_method, device)

    def fit(self, x, y, *, tol=None, max_iters: int = 100, solver: str = "auto",
            precond_rank: int = 512, cg_tol: Optional[float] = None,
            cg_max_iters: Optional[int] = None) -> "GPBinaryClassifier":
        """``solver``: "cholesky" (dense Newton), "cg" (matrix-free Newton,
        ``gp.laplace_fit_cg``), or "auto" (cg above n = 32768). ``cg_tol``
        and ``cg_max_iters``: each Newton step's CG tolerance and cap on the
        cg route (default 1e-6 and 200); the Cholesky route refuses them."""
        solver, cg_args = self._store(x, solver, cg_tol, cg_max_iters)
        y = self._to_device(y)
        if solver == "cg":
            self.state = _cls.laplace_fit_cg(
                self.kernel, self.params, self.x_train, y, tol=tol, max_iters=max_iters,
                precond_rank=precond_rank, **cg_args,
            )
        else:
            self.state = _cls.fit_binary(
                self.kernel, self.params, self.x_train, y, tol=tol, max_iters=max_iters,
                dist_method=self.dist_method,
            )
        return self

    def _predict_full(self, x_test) -> _cls.BinaryPrediction:
        self._check_fitted()
        x_test = self._to_device(x_test)
        if self._solver == "cg":
            return _cls.predict_binary_cg(self.kernel, self.params, self.state, self.x_train,
                                          x_test)
        return _cls.predict_binary(self.kernel, self.params, self.state, self.x_train, x_test,
                                   dist_method=self.dist_method)

    def predict(self, x_test) -> torch.Tensor:
        """Labels in {-1, +1} [ref: GP_binary_classification.py:35-45]."""
        return self._predict_full(x_test).label

    def predict_proba(self, x_test, *, averaged: bool = False) -> torch.Tensor:
        p = self._predict_full(x_test)
        return p.prob_averaged if averaged else p.prob


class GPMulticlassClassifier(_Classifier):
    """Laplace multi-class GP classification (R&W Alg. 3.3, per-class n x n
    factorizations batched over classes: the reference's disabled trainer
    done right [ref: GP_multi_classification.py:66-126])."""

    def __init__(
        self,
        kernel: _k.Kernel,
        num_classes: int,
        params: Optional[_k.Params] = None,
        *,
        dist_method: str = "dot",
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(kernel, params, dist_method, device)
        self.num_classes = int(num_classes)
        self.y_labels = None

    def fit(self, x, y_labels, *, tol=None, max_iters: int = 100, solver: str = "auto",
            precond_rank: int = 512, cg_tol: Optional[float] = None,
            cg_max_iters: Optional[int] = None) -> "GPMulticlassClassifier":
        """``solver``: "cholesky" (per-class dense factorizations), "cg"
        (matrix-free stacked-system Newton, ``gp.laplace_fit_multiclass_cg``),
        or "auto" (cg above n = 32768). ``cg_tol`` and ``cg_max_iters``: each
        Newton step's CG tolerance and cap on the cg route (default 1e-6 and
        200); the Cholesky route refuses them."""
        solver, cg_args = self._store(x, solver, cg_tol, cg_max_iters)
        self.y_labels = self._to_device(y_labels)
        if solver == "cg":
            self.state = _mc.laplace_fit_multiclass_cg(
                self.kernel, self.params, self.x_train, self.y_labels, self.num_classes,
                tol=tol, max_iters=max_iters, precond_rank=precond_rank, **cg_args,
            )
        else:
            self.state = _mc.fit_multiclass(
                self.kernel, self.params, self.x_train, self.y_labels, self.num_classes,
                tol=tol, max_iters=max_iters, dist_method=self.dist_method,
            )
        return self

    def _predict_full(self, x_test) -> _mc.MulticlassPrediction:
        self._check_fitted()
        x_test = self._to_device(x_test)
        if self._solver == "cg":
            return _mc.predict_multiclass_cg(self.kernel, self.params, self.state,
                                             self.x_train, self.y_labels, x_test,
                                             self.num_classes)
        return _mc.predict_multiclass(self.kernel, self.params, self.state, self.x_train,
                                      self.y_labels, x_test, self.num_classes,
                                      dist_method=self.dist_method)

    def predict(self, x_test) -> torch.Tensor:
        """Integer class labels, the argmax over latent class means
        [ref: GP_multi_classification.py:179-197]."""
        return self._predict_full(x_test).label

    def predict_proba(self, x_test) -> torch.Tensor:
        """(num_classes, m) softmax class probabilities."""
        return self._predict_full(x_test).prob
