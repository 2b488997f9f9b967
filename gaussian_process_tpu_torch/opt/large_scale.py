"""Large-n LML hyperparameter training, matrix-free (torch counterpart of
``opt/large_scale.py``).

K is never materialised when ``use_kernel``: every matvec, forward and
reverse, streams kernel tiles through ``ops.cuda.gram_matvec`` (the CUDA
sweeps on an fp32 CUDA tensor). The estimator stack is the JAX package's:

- quadratic term: alpha = A^{-1} y by Nyström-preconditioned block CG; its
  gradient is +1/2 alpha^T (dA/dtheta) alpha;
- log-determinant gradient -1/2 tr(A^{-1} dA/dtheta) by Hutchinson:
  Rademacher probes z_i share the block CG solve (w_i = A^{-1} z_i), and
  the estimate is -1/2 mean_i w_i^T (dA/dtheta) z_i.

Both are bilinear forms in A, so one differentiable matvec on
V = [alpha | z] gives both terms (column 0 and columns 1 onward), and its
VJP carries both gradients: one training step is one block CG solve of
1 + num_probes columns plus one matvec VJP, with CUDA tensors one launch of
the backward sweep (the JAX package makes two). ``slq_logdet`` and
``lml_estimate`` give LML *values* by stochastic Lanczos quadrature.

An explicit ``torch.Generator`` takes the place of the JAX key: the probes
are drawn from it, so the port's probes are not the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.linalg import nystrom as _nys
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.opt import gradient as _grad
from gaussian_process_tpu_torch.utils import profiling as _profiling


def _make_matvec(kernel, x, noise_variance, use_kernel):
    """(params, v) -> (K(params) + shift) @ v with White folded into shift.

    v may be (n,) or (n, k). Differentiable in params and v (the kernel path
    through ``_GramMatvecFn``, the dense path through ``ops.gram``)."""

    def matvec(params, v):
        k_nw, p_nw, white = _k.split_white(kernel, params)
        shift = noise_variance + (white if white is not None else 0.0)
        vv = v[:, None] if v.ndim == 1 else v
        if use_kernel:
            out = _kops.gram_matvec(k_nw, p_nw, x, None, vv)
        else:
            out = _kops.gram(k_nw, p_nw, x) @ vv
        out = out + shift * vv
        return out[:, 0] if v.ndim == 1 else out

    return matvec


def _rademacher(shape, generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    """+-1 entries drawn with ``generator`` on its own device, returned on
    ``like``'s device and dtype."""
    device = generator.device if generator is not None else like.device
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(device=like.device, dtype=like.dtype)


def _objective(matvec, params, y, alpha, w, z):
    """The surrogate's params-dependent terms at fixed alpha, w and probes
    z, from one matvec on [alpha | z]:

    - quadratic term, value -1/2 y^T alpha; with A alpha = y its gradient
      is +1/2 alpha^T dA alpha, the gradient of
      -1/2 (2 y^T alpha - alpha^T A alpha) at fixed alpha;
    - logdet pullback -1/2 mean_i w_i^T A z_i (its gradient estimates
      -1/2 tr(A^{-1} dA); its value is a probe constant).

    Autograd hands the matvec's backward the cotangent
    [alpha / 2 | -w / (2 num_probes)]: one sweep for both gradients."""
    az = matvec(params, torch.cat([alpha[:, None], z], dim=1))
    quad = -0.5 * (2.0 * torch.dot(y, alpha) - torch.dot(alpha, az[:, 0]))
    logdet_est = -0.5 * torch.mean(torch.sum(w * az[:, 1:], dim=0))
    return quad + logdet_est


def _surrogate(kernel, params, x, y, generator, *, noise_variance, num_probes, cg_tol,
               cg_max_iters, precond_rank, use_kernel):
    """``lml_surrogate``'s value and the CG state of its solve."""
    if use_kernel is None:
        use_kernel = _kops.use_matvec_kernel(kernel, x)
    matvec = _make_matvec(kernel, x, noise_variance, use_kernel)
    n = y.shape[0]

    # the solves run outside the autograd graph at detached params (the JAX
    # package's stop_gradient): the Function then saves nothing per iteration
    with torch.no_grad():
        params_sg = _k.tree_map_params(lambda a: torch.as_tensor(a).detach(), params)
        k_nw, p_nw, white = _k.split_white(kernel, params_sg)
        shift = noise_variance + (white if white is not None else 0.0)
        pre = _nys.make_nystrom_preconditioner(
            k_nw, p_nw, x, shift=shift, rank=min(precond_rank, n)
        )
        z = _rademacher((n, num_probes), generator, y)
        rhs = torch.cat([y[:, None], z], dim=1)
        state = _cg.cg_solve(
            lambda v: matvec(params_sg, v), rhs, tol=cg_tol, max_iters=cg_max_iters,
            precond_apply=pre.apply,
        )
    alpha, w = state.x[:, 0], state.x[:, 1:]
    value = _objective(matvec, params, y, alpha, w, z)
    return value - 0.5 * n * math.log(2.0 * math.pi), state


def lml_surrogate(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise_variance: float = 1e-2,
    num_probes: int = 8,
    cg_tol: float = 1e-4,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Differentiable surrogate whose gradient is an unbiased estimate of
    dLML/dparams (up to CG tolerance), computable at n where K never fits.

        surrogate = -1/2 (2 y^T alpha - alpha^T A(params) alpha)
                    - 1/2 mean_i w_i^T A(params) z_i - n/2 log(2 pi)

    with alpha = A^{-1} y, z_i Rademacher probes drawn from ``generator``,
    w_i = A^{-1} z_i, and alpha, w held fixed. Its gradient is exactly
    +1/2 alpha^T dA alpha - 1/2 E[w^T dA z]; its value is the exact
    quadratic term minus a probe constant, an optimisation objective and
    not the LML (use ``gp.log_marginal_likelihood`` or :func:`lml_estimate`).

    ``use_kernel`` (the JAX package's ``use_pallas``): the CUDA matvec and
    its backward sweep; None means True for fp32 CUDA inputs and a
    stationary kernel.
    """
    value, _ = _surrogate(
        kernel, params, x, y, generator, noise_variance=noise_variance,
        num_probes=num_probes, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
        precond_rank=precond_rank, use_kernel=use_kernel,
    )
    return value


class LargeScaleResult(NamedTuple):
    params: Any  # detached, original space
    lml_trace: torch.Tensor  # surrogate objective per step (on the host)
    iters: int
    cg_iters: tuple  # CG iterations of each step's block solve


def tune_large_scale(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    noise_variance: float = 1e-2,
    learning_rate: float = 0.05,
    steps: int = 30,
    num_probes: int = 8,
    cg_tol: float = 1e-4,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    transform: str = "log",
    seed: int = 0,
    use_kernel: Optional[bool] = None,
) -> LargeScaleResult:
    """Adam ascent on the matrix-free LML surrogate (log-space params by
    default). One step = one Nyström-preconditioned block CG solve (y and
    the probes share every kernel tile) + one matvec on [alpha | z] and its
    VJP, which carries both terms' gradients; O(n * rank)
    memory. Probes are drawn from a generator seeded with ``seed`` on x's
    device."""
    to_opt, from_opt = _grad._transforms(transform)
    params = _k.tree_map_params(lambda a: torch.as_tensor(a, device=x.device), params)
    leaves = _grad.trainable_leaves(params, to_opt)
    opt = _grad.make_optimizer("adam", leaves, learning_rate)
    generator = torch.Generator(device=x.device).manual_seed(seed)
    trace, cg_iters = [], []
    for _ in range(steps):
        with _profiling.span("gp.training.step"):
            opt.zero_grad()
            value, state = _surrogate(
                kernel, from_opt(_k.tree_unflatten(params, leaves)), x, y, generator,
                noise_variance=noise_variance, num_probes=num_probes, cg_tol=cg_tol,
                cg_max_iters=cg_max_iters, precond_rank=precond_rank, use_kernel=use_kernel,
            )
            (-value).backward()
            opt.step()
            trace.append(float(value.detach()))
        cg_iters.append(state.iters)
    final = from_opt(_k.tree_unflatten(params, [leaf.detach() for leaf in leaves]))
    return LargeScaleResult(params=final, lml_trace=torch.tensor(trace, dtype=torch.float64),
                            iters=steps, cg_iters=tuple(cg_iters))


def slq_logdet(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise_variance: float = 1e-2,
    num_probes: int = 8,
    lanczos_iters: int = 32,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """log|K + s I| by stochastic Lanczos quadrature, matrix-free.

    Per Rademacher probe z: ``lanczos_iters`` steps of Lanczos on
    A = K + sI from z/||z||, the small tridiagonal T eigendecomposed, and
    ||z||^2 sum_j U[0,j]^2 log(lambda_j) accumulated; the probe mean
    estimates tr(log A) = log|A|. Full reorthogonalisation keeps the Ritz
    values honest in fp32.
    """
    if use_kernel is None:
        use_kernel = _kops.use_matvec_kernel(kernel, x)
    matvec = _make_matvec(kernel, x, noise_variance, use_kernel)
    return slq_logdet_matvec(
        lambda v: matvec(params, v), x.shape[0], generator, num_probes=num_probes,
        lanczos_iters=lanczos_iters, dtype=torch.promote_types(x.dtype, torch.float32),
        device=x.device,
    )


def slq_logdet_matvec(
    matvec,
    n: int,
    generator: Optional[torch.Generator] = None,
    *,
    num_probes: int = 8,
    lanczos_iters: int = 32,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """log|A| for an SPD operator given only ``matvec``: the generic core of
    :func:`slq_logdet`."""
    m = lanczos_iters
    like = torch.empty((), dtype=dtype, device=device)
    estimates = []
    for _ in range(num_probes):
        z = _rademacher((n,), generator, like)
        znorm2 = float(n)  # ||z||^2 = n for Rademacher
        q = z / math.sqrt(znorm2)
        Q = torch.zeros((n, m), dtype=dtype, device=device)
        q_prev = torch.zeros(n, dtype=dtype, device=device)
        beta_prev = torch.zeros((), dtype=dtype, device=device)
        alphas, betas = [], []
        for i in range(m):
            w = matvec(q) - beta_prev * q_prev
            alpha = torch.dot(w, q)
            w = w - alpha * q
            w = w - Q @ (Q.T @ w)  # full reorthogonalisation
            beta = torch.linalg.norm(w)
            q_next = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0), w)
            Q[:, i] = q
            alphas.append(alpha)
            betas.append(beta)
            q_prev, q, beta_prev = q, q_next, beta
        off = torch.stack(betas[:-1])
        T = torch.diag(torch.stack(alphas)) + torch.diag(off, 1) + torch.diag(off, -1)
        evals, evecs = torch.linalg.eigh(T)
        evals = torch.clamp(evals, min=torch.finfo(dtype).tiny)
        estimates.append(znorm2 * torch.sum(evecs[0, :] ** 2 * torch.log(evals)))
    return torch.mean(torch.stack(estimates))


def lml_estimate(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise_variance: float = 1e-2,
    num_probes: int = 8,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 400,
    precond_rank: int = 512,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """LML *value* estimate at large n: the exact quadratic term (one
    Nyström-preconditioned CG solve) + the SLQ logdet. The matrix-free
    stand-in for ``gp.log_marginal_likelihood`` when K cannot be built."""
    if use_kernel is None:
        use_kernel = _kops.use_matvec_kernel(kernel, x)
    matvec = _make_matvec(kernel, x, noise_variance, use_kernel)
    n = y.shape[0]
    k_nw, p_nw, white = _k.split_white(kernel, params)
    shift = noise_variance + (white if white is not None else 0.0)
    pre = _nys.make_nystrom_preconditioner(
        k_nw, p_nw, x, shift=shift, rank=min(precond_rank, n)
    )
    alpha = _cg.cg_solve(
        lambda v: matvec(params, v), y, tol=cg_tol, max_iters=cg_max_iters,
        precond_apply=pre.apply,
    ).x
    logdet = slq_logdet(
        kernel, params, x, generator, noise_variance=noise_variance,
        num_probes=num_probes, lanczos_iters=lanczos_iters, use_kernel=use_kernel,
    )
    return -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
