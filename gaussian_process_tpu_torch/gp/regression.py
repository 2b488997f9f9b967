"""Exact and matrix-free GP regression, Rasmussen & Williams Algorithm 2.1
(torch counterpart of ``gp/regression.py``).

    K   = k(X, X) + s I          (jittered Cholesky)
    L   = chol(K)
    a   = L^T \\ (L \\ y)
    mu* = K_s^T a
    v   = L \\ K_s
    var*= diag(K_ss) - sum(v^2, 0)
    LML = -0.5 y^T a - sum(log diag L) - n/2 log(2 pi)

Functions run on the device their tensors live on. The matrix-free path
(:func:`posterior_cg`) streams kernel tiles through the hand-written CUDA
matvec (``ops/cuda``) when its inputs are fp32 CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.linalg import nystrom as _nys
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops

# largest n for which posterior_cg builds K densely on the GPU (4 GiB in
# float32, 8 GiB in float64); beyond it only the CUDA matvec may run
DENSE_CUDA_MAX_N = 32768


def _solve_cfg(cfg):
    return _config.DEFAULT_SOLVE if cfg is None else cfg


def _min_retry(dtype: torch.dtype) -> float:
    """First retry jitter, scaled to the rounding of K as computed (in the
    input dtype), as ``safe_cholesky`` scales it by default."""
    return 10.0 * torch.finfo(dtype).eps


def _normal(shape, generator: Optional[torch.Generator], like: torch.Tensor):
    """Standard normals drawn with ``generator`` on its own device, returned
    on ``like``'s device and dtype."""
    gen_device = generator.device if generator is not None else like.device
    eps = torch.randn(shape, generator=generator, dtype=like.dtype, device=gen_device)
    return eps.to(like.device)


class Posterior(NamedTuple):
    mean: torch.Tensor  # (n_test,) posterior mean mu*
    var: torch.Tensor  # (n_test,) posterior marginal variance
    std: torch.Tensor  # sqrt(var)
    lml: torch.Tensor  # scalar log marginal likelihood (corrected formula)
    chol: torch.Tensor  # (n_train, n_train) L with K + sI = L L^T
    alpha: torch.Tensor  # (n_train,) K^-1 y
    v: torch.Tensor  # (n_train, n_test) L \\ K_s (for joint sampling)
    jitter: torch.Tensor  # jitter applied, the noise term included


def posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    *,
    noise_variance: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> Posterior:
    """Full exact-GP posterior at ``x_test`` (Alg. 2.1). An explicit
    ``noise_variance`` overrides ``cfg.noise_variance``."""
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    K = _k.gram(kernel, params, x_train, method=dist_method)
    dtype, work = K.dtype, _chol.solve_dtype(K.dtype)
    K = K.to(work)
    K_s = _k.gram(kernel, params, x_train, x_test, method=dist_method).to(work)
    kss_diag = _k.gram_diag(kernel, params, x_test).to(work)
    res = _chol.safe_cholesky(
        K,
        initial_jitter=noise_variance,
        min_retry_jitter=_min_retry(dtype),
        jitter_growth=cfg.jitter_growth,
        max_attempts=cfg.max_chol_attempts,
    )
    L = res.factor
    # y rides the K_s forward solve. With z = L^{-1}[y | K_s]:
    #   y^T alpha = z_y^T z_y,   var* = diag(K_ss) - sum(v^2)
    z_all = _chol.tri_solve(L, torch.cat([y_train.to(work)[:, None], K_s], dim=1))
    z_y = z_all[:, 0]
    v = z_all[:, 1:]
    alpha = _chol.tri_solve(L, z_y, trans=True)
    mean = K_s.T @ alpha
    var = torch.clamp(kss_diag - torch.sum(v * v, dim=0), min=0.0)
    n = x_train.shape[0]
    lml = (
        -0.5 * torch.dot(z_y, z_y)
        - torch.sum(torch.log(torch.diagonal(L)))
        - 0.5 * n * math.log(2.0 * math.pi)
    )
    post = Posterior(
        mean=mean,
        var=var,
        std=torch.sqrt(var),
        lml=lml,
        chol=L,
        alpha=alpha,
        v=v,
        jitter=res.jitter,
    )
    return Posterior(*(field.to(dtype) for field in post))


def log_marginal_likelihood(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    noise_variance: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> torch.Tensor:
    """Corrected LML; autograd flows into ``params``."""
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    K = _k.gram(kernel, params, x_train, method=dist_method)
    dtype, work = K.dtype, _chol.solve_dtype(K.dtype)
    y_train = y_train.to(work)
    L = _chol.safe_cholesky(
        K.to(work),
        initial_jitter=noise_variance,
        min_retry_jitter=_min_retry(dtype),
        jitter_growth=cfg.jitter_growth,
        max_attempts=cfg.max_chol_attempts,
    ).factor
    alpha = _chol.cholesky_solve(L, y_train)
    n = x_train.shape[0]
    lml = (
        -0.5 * torch.dot(y_train, alpha)
        - torch.sum(torch.log(torch.diagonal(L)))
        - 0.5 * n * math.log(2.0 * math.pi)
    )
    return lml.to(dtype)


def sample_prior(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    num_functions: int = 10,
    jitter: float = 5e-4,
    mean: float = 0.0,
    dist_method: str = "dot",
) -> torch.Tensor:
    """Draw ``num_functions`` GP prior paths at ``x``: mu + L N(0, I)."""
    K = _k.gram(kernel, params, x, method=dist_method)
    L = _chol.safe_cholesky(K, initial_jitter=jitter).factor
    eps = _normal((x.shape[0], num_functions), generator, K)
    return mean + L @ eps


def sample_posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    post: Posterior,
    x_test: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    num_functions: int = 10,
    jitter: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> torch.Tensor:
    """Joint posterior samples at the test points: chol(K_ss + jitter I -
    v^T v) applied to standard normals, plus the posterior mean."""
    if jitter is None:
        jitter = _solve_cfg(cfg).sampling_jitter
    K_ss = _k.gram(kernel, params, x_test, method=dist_method)
    cov = K_ss - post.v.T @ post.v
    L = _chol.safe_cholesky(cov, initial_jitter=jitter).factor
    eps = _normal((x_test.shape[0], num_functions), generator, K_ss)
    return post.mean[:, None] + L @ eps


class CGPosterior(NamedTuple):
    mean: torch.Tensor  # (n_test,)
    var: torch.Tensor  # (n_test,) predictive marginal variance
    std: torch.Tensor
    iters: int  # total CG iterations across all solves
    resnorm: torch.Tensor  # worst final residual norm across solves


def posterior_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    *,
    noise_variance: Optional[float] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    test_chunk: int = 512,
    use_kernel: Optional[bool] = None,
    preconditioner: str = "auto",
    precond_rank: Optional[int] = None,
    cfg: Optional[_config.SolveConfig] = None,
) -> CGPosterior:
    """Matrix-free exact-GP posterior (mean and variance) at large n.

    K(X, X) is never materialised when ``use_kernel``: every matvec
    streams kernel tiles through ``ops.cuda.gram_matvec``. The default is
    True for fp32 CUDA inputs and a stationary kernel; otherwise K is built
    densely (CPU, or float64 / a non-stationary kernel on the GPU, which
    raises above ``DENSE_CUDA_MAX_N``). For each chunk C of test points,

        U = (K + s I)^{-1} K_sC        (one block-CG solve)
        var_C = diag(K_CC) - sum(K_sC * U, axis=0)

    and alpha rides the first chunk's block solve as an extra column.

    ``preconditioner``: "nystrom" (rank ``precond_rank`` landmarks),
    "jacobi", "none", or "auto" (nystrom above n = 4096, jacobi below).
    ``precond_rank=None`` scales the rank with n: min(2048, max(512, n // 50)).
    """
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    if tol is None:
        tol = cfg.cg_tol
    if max_iters is None:
        max_iters = cfg.cg_max_iters
    x_train = _k._dist._as_2d(x_train)
    x_test = _k._dist._as_2d(x_test)
    n = x_train.shape[0]
    m = x_test.shape[0]

    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    shift = noise_variance + (white_var if white_var is not None else 0.0)

    if use_kernel is None:
        use_kernel = (
            x_train.is_cuda
            and x_train.dtype == torch.float32
            and _k.is_stationary(kernel)
        )
    if use_kernel:
        matvec = lambda v: _kops.gram_matvec(k_nw, p_nw, x_train, None, v)
    else:
        if x_train.is_cuda and n > DENSE_CUDA_MAX_N:
            raise ValueError(
                f"posterior_cg at n = {n} on the GPU needs the matrix-free CUDA "
                "matvec, which takes float32 inputs and a stationary kernel only "
                f"(got {x_train.dtype}, {type(kernel).__name__}); without it K "
                f"is built densely, which is allowed up to n = {DENSE_CUDA_MAX_N}"
            )
        K = _k.gram(k_nw, p_nw, x_train)
        matvec = lambda v: K @ v

    noisy_mv = lambda v: matvec(v) + shift * v
    if preconditioner == "auto":
        preconditioner = "nystrom" if n > 4096 else "jacobi"
    if precond_rank is None:
        precond_rank = min(2048, max(512, n // 50))
    if preconditioner == "nystrom":
        pre = _nys.make_nystrom_preconditioner(
            k_nw, p_nw, x_train, shift=shift, rank=precond_rank
        )
        precond_kwargs = {"precond_apply": pre.apply}
    elif preconditioner == "jacobi":
        precond_kwargs = {"precond_diag": _k.gram_diag(k_nw, p_nw, x_train) + shift}
    elif preconditioner == "none":
        precond_kwargs = {}
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    chunk = min(test_chunk, m)
    kss = _k.gram_diag(kernel, params, x_test)  # full kernel: White counts
    means, variances = [], []
    total_iters = 0
    worst_res = torch.zeros((), dtype=x_train.dtype, device=x_train.device)
    alpha = None
    for c0 in range(0, m, chunk):
        Ks = _k.gram(k_nw, p_nw, x_train, x_test[c0 : c0 + chunk])  # (n, chunk)
        rhs = torch.cat([y_train[:, None], Ks], dim=1) if c0 == 0 else Ks
        state = _cg.cg_solve(
            noisy_mv, rhs, tol=tol, max_iters=max_iters, **precond_kwargs
        )
        U = state.x
        if c0 == 0:
            alpha = U[:, 0]
            U = U[:, 1:]
        means.append(Ks.T @ alpha)
        variances.append(kss[c0 : c0 + chunk] - torch.sum(Ks * U, dim=0))
        total_iters += state.iters
        worst_res = torch.maximum(worst_res, state.resnorm)

    mean = torch.cat(means)
    var = torch.clamp(torch.cat(variances), min=0.0)
    return CGPosterior(
        mean=mean, var=var, std=torch.sqrt(var), iters=total_iters, resnorm=worst_res
    )


def posterior_mean_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    cross_mv: Callable[[torch.Tensor], torch.Tensor],
    y_train: torch.Tensor,
    *,
    noise_variance: float = 5e-4,
    prior_diag: Optional[torch.Tensor] = None,
    tol: float = 1e-6,
    max_iters: int = 1000,
) -> tuple[torch.Tensor, _cg.CGState]:
    """Posterior mean via matrix-free CG: mu* = K_s^T (K + sI)^-1 y.

    ``matvec(v)`` returns K(X, X) @ v (without noise); ``cross_mv(alpha)``
    returns K_s^T @ alpha.
    """
    noisy_mv = lambda v: matvec(v) + noise_variance * v
    diag = None if prior_diag is None else prior_diag + noise_variance
    state = _cg.cg_solve(
        noisy_mv, y_train, tol=tol, max_iters=max_iters, precond_diag=diag
    )
    return cross_mv(state.x), state
