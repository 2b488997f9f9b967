"""Exact and matrix-free GP regression, Rasmussen & Williams Algorithm 2.1
(torch counterpart of ``gp/regression.py``).

    K   = k(X, X) + s I          (jittered Cholesky)
    L   = chol(K)
    a   = L^T \\ (L \\ y)
    mu* = K_s^T a
    v   = L \\ K_s
    var*= diag(K_ss) - sum(v^2, 0)
    LML = -0.5 y^T a - sum(log diag L) - n/2 log(2 pi)

Functions run on the device their tensors live on. Every dense gram goes
through ``ops.cuda.kernel_ops.gram``: the hand-written CUDA tile gram for
fp32 CUDA inputs and a stationary kernel. (The JAX package keeps XLA's gram
in its solve, where a Pallas call would break XLA's fusion; eager PyTorch
has no fusion to break, and its plain gram is several full-matrix passes.)
The matrix-free path (:func:`posterior_cg`) streams kernel tiles through the
hand-written CUDA matvec (``ops/cuda``) when its inputs are fp32 CUDA
tensors.
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
from gaussian_process_tpu_torch.utils import profiling as _profiling

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
    K = _kops.gram(kernel, params, x_train, method=dist_method)
    dtype, work = K.dtype, _chol.solve_dtype(K.dtype)
    K = K.to(work)
    K_s = _kops.gram(kernel, params, x_train, x_test, method=dist_method).to(work)
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
    K = _kops.gram(kernel, params, x_train, method=dist_method)
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
    K = _kops.gram(kernel, params, x, method=dist_method)
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
    K_ss = _kops.gram(kernel, params, x_test, method=dist_method)
    cov = K_ss - post.v.T @ post.v
    L = _chol.safe_cholesky(cov, initial_jitter=jitter).factor
    eps = _normal((x_test.shape[0], num_functions), generator, K_ss)
    return post.mean[:, None] + L @ eps


def cg_dot_mode(tol: float) -> str:
    """The matvec's ``dot_mode`` for a CG tolerance, the JAX package's rule
    (``gp/regression.py``, ADVICE r4): "highest" (full fp32) below 1e-5,
    where the recurrence residual would "converge" past the TPU's split
    product's precision, else "split3". On the card both modes take the
    same products (``ops.cuda.kernel_ops.gram_matvec``)."""
    return "highest" if tol < 1e-5 else "split3"


def kernel_operator(kernel: _k.Kernel, params: _k.Params, x: torch.Tensor,
                    use_kernel: Optional[bool], dot_mode: str = "split3",
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> K(x, x) v, White included, for v (n,) or (n, r): the matvec of
    every matrix-free path. ``use_kernel`` (the JAX package's
    ``use_pallas``): one ``ops.cuda.gram_matvec`` sweep (K3 for thin v, K2
    for wide v) under ``dot_mode`` (:func:`cg_dot_mode`); None means
    ``ops.cuda.kernel_ops.use_matvec_kernel``. Otherwise a dense K, which a
    CUDA tensor may hold only up to ``DENSE_CUDA_MAX_N`` points."""
    if use_kernel is None:
        use_kernel = _kops.use_matvec_kernel(kernel, x)
    if use_kernel:
        return lambda v: _kops.gram_matvec(kernel, params, x, None, v, dot_mode=dot_mode)
    if x.is_cuda and x.shape[0] > DENSE_CUDA_MAX_N:
        raise ValueError(
            f"a matrix-free solve at n = {x.shape[0]} on the GPU needs the CUDA matvec, "
            f"which takes float32 inputs and a stationary kernel only (got {x.dtype}, "
            f"{type(kernel).__name__}); a dense K is allowed up to n = {DENSE_CUDA_MAX_N}"
        )
    K = _kops.gram(kernel, params, x)
    return lambda v: K @ v


class CGPosterior(NamedTuple):
    mean: torch.Tensor  # (n_test,)
    var: torch.Tensor  # (n_test,) predictive marginal variance
    std: torch.Tensor
    iters: int  # total CG iterations across all solves
    resnorm: torch.Tensor  # worst final residual norm across solves


@torch.no_grad()
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

    Runs under ``torch.no_grad()``, as the JAX ``posterior_cg`` is never
    differentiated: serving with trained params records no graph.
    """
    with _profiling.span("gp.posterior.query"):
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
            use_kernel = _kops.use_matvec_kernel(kernel, x_train)
        matvec = kernel_operator(k_nw, p_nw, x_train, use_kernel, cg_dot_mode(tol))
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
            Ks = _kops.gram(k_nw, p_nw, x_train, x_test[c0 : c0 + chunk])  # (n, chunk)
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


class SegmentedSnapshot(NamedTuple):
    """The whole resumable state of a :func:`posterior_cg_segmented` run.

    Emitted through ``snapshot_cb`` after every segment and accepted back
    through ``resume=``: a fresh process continues the solve where a
    stopped one left it, mid-chunk with conjugacy kept (``cg_solve``'s
    ``init_state``), with the finished chunks' results carried along. Every
    leaf is a tensor or a scalar, so the tuple round-trips through
    ``utils.checkpoint``. ``n``, ``m`` and ``test_chunk`` record the problem
    the state belongs to; a resume on another problem raises.
    """

    chunk: int  # index of the chunk ``state`` belongs to
    state: _cg.CGState  # mid-solve CG state of that chunk
    alpha: Optional[torch.Tensor]  # (n,) weights, once chunk 0 finished
    means: tuple  # finished chunks' posterior-mean blocks
    variances: tuple  # finished chunks' variance blocks
    total_iters: int  # CG iterations spent in finished chunks
    worst_res: float  # worst final residual across finished chunks
    n: int  # training points
    m: int  # test points
    test_chunk: int  # test points per chunk, as passed


@torch.no_grad()
def posterior_cg_segmented(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    *,
    noise_variance: Optional[float] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    segment_iters: int = 40,
    test_chunk: int = 8,
    use_kernel: Optional[bool] = None,
    precond_rank: Optional[int] = None,
    checkpoint_cb=None,
    snapshot_cb=None,
    resume: Optional[SegmentedSnapshot] = None,
    cfg: Optional[_config.SolveConfig] = None,
) -> CGPosterior:
    """Matrix-free posterior like :func:`posterior_cg`, as a loop of
    bounded segments: each runs at most ``segment_iters`` CG iterations and
    returns the full ``CGState``, which the next segment resumes exactly
    (``cg_solve``'s ``init_state``: conjugacy kept, not an x0 restart).

    ``snapshot_cb`` receives a :class:`SegmentedSnapshot` after every
    segment (persist it with ``utils.checkpoint``); passing one back as
    ``resume=`` continues the solve where it stopped, finished chunks not
    recomputed. A snapshot of another problem (other n, m or
    ``test_chunk``) raises ``ValueError``. ``checkpoint_cb(chunk_index,
    CGState)`` is the state-only hook and fires too.

    The matvec is :func:`kernel_operator` under :func:`cg_dot_mode`, and
    the Nyström preconditioner is built once per call from strided
    landmarks, so a fresh process rebuilds the same factor. Chunks of
    ``test_chunk`` test points are solved one after another, alpha riding
    the first chunk's block as an extra column.
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
    if resume is not None and (resume.n, resume.m, resume.test_chunk) != (n, m, test_chunk):
        raise ValueError(
            f"the snapshot belongs to n={resume.n}, m={resume.m}, "
            f"test_chunk={resume.test_chunk}; this call has n={n}, m={m}, "
            f"test_chunk={test_chunk}"
        )

    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    shift = noise_variance + (white_var if white_var is not None else 0.0)
    matvec = kernel_operator(k_nw, p_nw, x_train, use_kernel, cg_dot_mode(tol))
    noisy_mv = lambda v: matvec(v) + shift * v
    if precond_rank is None:
        precond_rank = min(2048, max(512, n // 50))
    pre = _nys.make_nystrom_preconditioner(
        k_nw, p_nw, x_train, shift=shift, rank=min(precond_rank, n)
    )

    chunk = min(test_chunk, m)
    n_chunks = -(-m // chunk)
    kss = _k.gram_diag(kernel, params, x_test)  # full kernel: White counts
    if resume is not None:
        start_chunk = int(resume.chunk)
        means, variances = list(resume.means), list(resume.variances)
        alpha = resume.alpha
        total_iters = int(resume.total_iters)
        worst_res = float(resume.worst_res)
    else:
        start_chunk, means, variances = 0, [], []
        total_iters, worst_res, alpha = 0, 0.0, None
    for c in range(start_chunk, n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        Ks = _kops.gram(k_nw, p_nw, x_train, x_test[sl])  # (n, chunk)
        rhs = torch.cat([y_train[:, None], Ks], dim=1) if c == 0 else Ks
        stop = float(tol) * max(float(torch.sqrt(torch.max(torch.sum(rhs * rhs, dim=0)))),
                                1e-30)

        def segment(state):
            state = _cg.cg_solve(noisy_mv, rhs, tol=tol, max_iters=max_iters,
                                 precond_apply=pre.apply, init_state=state,
                                 max_new_iters=segment_iters)
            if checkpoint_cb is not None:
                checkpoint_cb(c, state)
            if snapshot_cb is not None:
                snapshot_cb(SegmentedSnapshot(
                    chunk=c, state=state, alpha=alpha, means=tuple(means),
                    variances=tuple(variances), total_iters=total_iters,
                    worst_res=worst_res, n=n, m=m, test_chunk=test_chunk,
                ))
            return state

        # the interrupted chunk continues exactly from its CG state
        state = segment(resume.state if resume is not None and c == start_chunk else None)
        while float(state.resnorm) > stop and state.iters < max_iters:
            prev_iters = state.iters
            state = segment(state)
            if state.iters == prev_iters:
                break  # no progress possible (the cap was reached inside)
        U = state.x
        if c == 0:
            # contiguous, as a checkpoint restores it: a strided vector would
            # take another product order, and a resumed run other bits
            alpha = U[:, 0].contiguous()
            U = U[:, 1:]
        means.append(Ks.T @ alpha)
        variances.append(kss[sl] - torch.sum(Ks * U, dim=0))
        total_iters += state.iters
        worst_res = max(worst_res, float(state.resnorm))

    mean = torch.cat(means)
    var = torch.clamp(torch.cat(variances), min=0.0)
    return CGPosterior(
        mean=mean, var=var, std=torch.sqrt(var), iters=total_iters,
        resnorm=torch.tensor(worst_res, dtype=x_train.dtype, device=x_train.device),
    )
