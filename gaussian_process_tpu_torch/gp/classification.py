"""Binary GP classification with the Laplace approximation, R&W Alg. 3.1/3.2
(torch counterpart of ``gp/classification.py``).

- Dense: :func:`laplace_fit` (true Newton; ``mode="reference"`` reproduces
  the reference's frozen-W solve, quirk Q2), :func:`laplace_predict`,
  :func:`fit_binary`, :func:`predict_binary`.
- Matrix-free: :func:`laplace_fit_cg` and :func:`predict_binary_cg`, where
  every B = I + sW K sW matvec is one kernel sweep (``ops.cuda.gram_matvec``:
  the CUDA sweeps on fp32 CUDA inputs) and each solve is CG preconditioned by
  Woodbury over a Nyström factor of K.

The JAX ``lax.while_loop`` becomes a Python loop with the same stop rule,
reading the relative step ||f_new - f|| / (1 + ||f_new||) on the host once
per Newton iteration; ``iters`` and ``converged`` are Python values. The
loops run under ``torch.no_grad()``: the JAX while_loop is not
reverse-differentiable either.

Every dense K and cross-gram comes from ``ops.cuda.kernel_ops.gram`` (the
CUDA tile gram for fp32 CUDA inputs). The factor of B stays in K's dtype:
B's eigenvalues are >= 1, unlike the regression path's K + s I at
s = 5e-4, which the port factorizes in float64. Inputs of shape (n,) are
n points of dimension 1 (the JAX package's ``jnp.atleast_2d`` in its
matrix-free paths turns them into one point of dimension n).

Labels are {-1, +1} with the logistic link pi(f) = sigmoid(f)
[ref: GP_binary_classification.py:48-83].
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.linalg import nystrom as _nys
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.opt import large_scale as _ls


class BinaryLaplaceState(NamedTuple):
    f_mode: torch.Tensor  # (n,) Newton mode of the latent posterior
    grad_at_mode: torch.Tensor  # (n,) t - pi(f_mode)   (= alpha at the mode)
    sqrt_w: torch.Tensor  # (n,) sqrt(pi (1 - pi)) at the mode
    chol_B: torch.Tensor  # (n, n) L with I + sW K sW = L L^T
    lml: torch.Tensor  # scalar Laplace-approximate log marginal likelihood
    iters: int
    converged: bool
    error_trace: torch.Tensor  # (max_iters,) per-iteration error, NaN-padded


def _log_sigmoid_likelihood(y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """sum_i log sigmoid(y_i f_i), the stable form of the reference's
    -log(1 + e^{-z}) [ref: GP_binary_classification.py:57-62]."""
    return torch.sum(F.logsigmoid(y * f))


def _newton_args(tol, max_iters, cfg):
    if cfg is not None:
        if tol is None and cfg.tol is not None:
            tol = cfg.tol
        if max_iters is None:
            max_iters = cfg.max_iters
    return tol, 100 if max_iters is None else max_iters


def _default_tol(dtype: torch.dtype) -> float:
    """float32's Newton error floor sits near sqrt(eps) ||f||; float64
    reaches the reference's absolute tolerances easily."""
    return 10.0 * math.sqrt(torch.finfo(dtype).eps)


def _rel_step(f_new: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The relative criterion, scale-free across dtypes and sizes."""
    return torch.linalg.norm(f_new - f) / (1.0 + torch.linalg.norm(f_new))


def _iterate(step, f, tol, max_iters, err_fn):
    """The Newton loop: ``step(f) -> (f_new, *extra)`` while the error
    exceeds ``tol``, at most ``max_iters`` times. Returns (f, last extra or
    None, iters, error, error_trace)."""
    trace = torch.full((max_iters,), float("nan"), dtype=f.dtype, device=f.device)
    i, err, extra = 0, math.inf, None
    # float(nan) > tol is False: a NaN error stops the loop, as the JAX
    # while_loop's condition does
    while i < max_iters and err > tol:
        f_new, *extra = step(f)
        e = err_fn(f_new, f)
        trace[i] = e
        err = float(e)
        f = f_new
        i += 1
    return f, extra, i, err, trace


def _labels(y, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(y).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def laplace_fit(
    K: torch.Tensor,
    y: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    f_init: Optional[torch.Tensor] = None,
    mode: str = "newton",
    cfg: Optional[_config.NewtonConfig] = None,
) -> BinaryLaplaceState:
    """Newton iteration to the Laplace mode given a dense prior K.

    ``cfg`` supplies tol/max_iters defaults; explicit arguments win. Each
    step (R&W Alg. 3.1): W = pi(1-pi); L = chol(I + sW K sW);
    b = W f + (t - pi); a = b - sW L^T \\ (L \\ (sW (K b))); f <- K a.
    ``f_init`` warm-starts the iteration (default zeros).

    ``mode="reference"`` reproduces the reference's training loop as
    written (quirk Q2): the gradient and W are evaluated once at ``f_init``
    and frozen, f iterates from zero through the linearised update, and the
    returned ``grad_at_mode``/``sqrt_w``/``chol_B`` are the frozen ones,
    which the reference's prediction consumes
    [ref: GP_binary_classification.py:86-154].
    """
    tol, max_iters = _newton_args(tol, max_iters, cfg)
    if mode == "reference":
        return _laplace_fit_reference(K, y, tol=tol, max_iters=max_iters, f_init=f_init)
    if mode != "newton":
        raise ValueError(f"unknown mode {mode!r} (expected 'newton' or 'reference')")
    y = _labels(y, K)  # integer {-1, +1} labels are fine to pass
    if tol is None:
        tol = _default_tol(K.dtype)
    t = (y + 1.0) / 2.0
    f0 = torch.zeros_like(y) if f_init is None else _labels(f_init, K)

    def step(f):
        pi = torch.sigmoid(f)
        grad = t - pi
        w = pi * (1.0 - pi)
        sw = torch.sqrt(w)
        B = sw[:, None] * K * sw[None, :]
        B.diagonal().add_(1.0)
        L = torch.linalg.cholesky_ex(B).L
        b = w * f + grad
        a = b - sw * _chol.cholesky_solve(L, sw * (K @ b))
        return K @ a, a, L, sw, grad

    f, _, iters, err, trace = _iterate(step, f0, tol, max_iters, _rel_step)
    # the mode's artifacts at the converged f (a = K^-1 f)
    _, a, L, sw, grad = step(f)
    lml = (
        -0.5 * torch.dot(a, f)
        + _log_sigmoid_likelihood(y, f)
        - torch.sum(torch.log(torch.diagonal(L)))
    )
    return BinaryLaplaceState(f_mode=f, grad_at_mode=grad, sqrt_w=sw, chol_B=L, lml=lml,
                              iters=iters, converged=err <= tol, error_trace=trace)


def _laplace_fit_reference(K, y, *, tol=None, max_iters=100, f_init=None) -> BinaryLaplaceState:
    """The reference's frozen-W linearised solve (quirk Q2); see
    :func:`laplace_fit`."""
    y = _labels(y, K)
    if tol is None:
        tol = 1e-4  # the reference's absolute tolerance [ref: GP_binary_classification.py:98]
    t = (y + 1.0) / 2.0
    f0 = torch.zeros_like(y) if f_init is None else _labels(f_init, K)
    # gradient frozen at f_init with the reference's y*f argument [ref: :74],
    # W with its f argument [ref: :83, :105]
    grad0 = t - torch.sigmoid(y * f0)
    pi0 = torch.sigmoid(f0)
    w0 = pi0 * (1.0 - pi0)
    sw = torch.sqrt(w0)
    B = sw[:, None] * K * sw[None, :]
    B.diagonal().add_(1.0)
    L = torch.linalg.cholesky_ex(B).L

    def a_of(f):
        b = w0 * f + grad0
        return b - sw * _chol.cholesky_solve(L, sw * (K @ b))

    # the reference starts the iterate at zero whatever f_init is [ref: :100]
    # and stops on the absolute error ||f_new - f|| [ref: :113]
    f, _, iters, err, trace = _iterate(
        lambda f: (K @ a_of(f),), torch.zeros_like(y), tol, max_iters,
        lambda f_new, f: torch.linalg.norm(f_new - f),
    )
    a = a_of(f)  # = K^-1 f at the fixed point
    lml = (
        -0.5 * torch.dot(a, f)
        + _log_sigmoid_likelihood(y, f)
        - torch.sum(torch.log(torch.diagonal(L)))
    )
    return BinaryLaplaceState(f_mode=f, grad_at_mode=grad0, sqrt_w=sw, chol_B=L, lml=lml,
                              iters=iters, converged=err <= tol, error_trace=trace)


class BinaryPrediction(NamedTuple):
    mean: torch.Tensor  # (m,) latent mean f_bar*
    var: torch.Tensor  # (m,) latent variance
    prob: torch.Tensor  # (m,) P(y=+1) = sigmoid(f_bar*) (the reference's MAP rule)
    prob_averaged: torch.Tensor  # (m,) MacKay-style variance-corrected prob
    label: torch.Tensor  # (m,) in {-1, +1}


def _prediction(mean: torch.Tensor, var: torch.Tensor) -> BinaryPrediction:
    prob = torch.sigmoid(mean)
    kappa = 1.0 / torch.sqrt(1.0 + math.pi * var / 8.0)
    one = torch.ones_like(prob)
    return BinaryPrediction(mean=mean, var=var, prob=prob,
                            prob_averaged=torch.sigmoid(kappa * mean),
                            label=torch.where(prob >= 0.5, one, -one))


def laplace_predict(
    state: BinaryLaplaceState, K_s: torch.Tensor, kss_diag: torch.Tensor
) -> BinaryPrediction:
    """Batched R&W Alg. 3.2 prediction: f_bar* = K_s^T (t - pi);
    v = L \\ (sW K_s); var = diag(K_ss) - sum v^2. Label rule
    sigmoid(f_bar*) >= 0.5 [ref: GP_binary_classification.py:35-45,
    136-154]; ``prob_averaged`` integrates the latent Gaussian with the
    logit-probit approximation (not in the reference)."""
    mean = K_s.T @ state.grad_at_mode
    v = _chol.tri_solve(state.chol_B, state.sqrt_w[:, None] * K_s)
    var = torch.clamp(kss_diag - torch.sum(v * v, dim=0), min=0.0)
    return _prediction(mean, var)


def fit_binary(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    dist_method: str = "dot",
    f_init: Optional[torch.Tensor] = None,
    mode: str = "newton",
    cfg: Optional[_config.NewtonConfig] = None,
) -> BinaryLaplaceState:
    """Build K (the tile gram on fp32 CUDA inputs), then Newton
    [ref: GP_binary_classification.py:179]."""
    K = _kops.gram(kernel, params, x_train, method=dist_method)
    return laplace_fit(K, y_train, tol=tol, max_iters=max_iters, f_init=f_init, mode=mode,
                       cfg=cfg)


def predict_binary(
    kernel: _k.Kernel,
    params: _k.Params,
    state: BinaryLaplaceState,
    x_train: torch.Tensor,
    x_test: torch.Tensor,
    *,
    dist_method: str = "dot",
) -> BinaryPrediction:
    K_s = _kops.gram(kernel, params, x_train, x_test, method=dist_method)
    kss = _k.gram_diag(kernel, params, x_test)
    return laplace_predict(state, K_s, kss)


# ------------------------------------------------- matrix-free (large n)


class BinaryLaplaceCGState(NamedTuple):
    """Laplace mode artifacts without any n x n factor: the large-n
    counterpart of :class:`BinaryLaplaceState`."""

    f_mode: torch.Tensor  # (n,)
    grad_at_mode: torch.Tensor  # (n,) t - pi(f_mode)
    sqrt_w: torch.Tensor  # (n,)
    U: torch.Tensor  # (n, r) Nyström factor of K (float64 for fp32 inputs)
    lml: torch.Tensor  # SLQ-estimated Laplace LML (NaN unless compute_lml)
    iters: int  # Newton iterations
    inner_iters: int  # total CG iterations across Newton steps
    converged: bool
    error_trace: torch.Tensor


def woodbury_apply(V: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> (I + V V^T)^{-1} v = v - V (I + V^T V)^{-1} V^T v, built and
    applied in V's dtype and returned in v's.

    V is the Nyström factor scaled by sW, in float64 for fp32 inputs: the
    apply cancels by up to the largest eigenvalue of sW K sW, as the
    regression path's Nyström apply does, and in fp32 that apply made CG
    diverge at n = 102400."""
    r = V.shape[1]
    G = torch.eye(r, dtype=V.dtype, device=V.device) + V.T @ V
    chol_G = _chol.safe_cholesky(G).factor

    def apply(v):
        vv = (v[:, None] if v.ndim == 1 else v).to(V.dtype)
        out = (vv - V @ _chol.cholesky_solve(chol_G, V.T @ vv)).to(v.dtype)
        return out[:, 0] if v.ndim == 1 else out

    return apply


def _b_matvec(Kmv, sw: torch.Tensor):
    """v -> (I + sW K sW) v for v (n,) or (n, r)."""

    def Bmv(v):
        s = sw if v.ndim == 1 else sw[:, None]
        return v + s * Kmv(s * v)

    return Bmv


def _lml_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """The SLQ probes' generator: seed 0 on ``device`` unless one is given
    (the JAX package's default ``jax.random.key(0)``)."""
    return torch.Generator(device=device).manual_seed(0) if generator is None else generator


@torch.no_grad()
def laplace_fit_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    use_kernel: Optional[bool] = None,
    f_init: Optional[torch.Tensor] = None,
    precond_factor: Optional[torch.Tensor] = None,
    compute_lml: bool = False,
    lml_probes: int = 8,
    lml_lanczos_iters: int = 32,
    lml_generator: Optional[torch.Generator] = None,
    cfg: Optional[_config.NewtonConfig] = None,
) -> BinaryLaplaceCGState:
    """True-Newton Laplace fit with matrix-free inner solves: K is never
    materialised (with ``use_kernel``), so binary classification reaches
    the n ~ 1e5 tier of ``gp.posterior_cg``.

    Each Newton step solves B z = sW K b by CG, where every B matvec is
    ``v + sW K (sW v)``: one kernel sweep. The preconditioner is Woodbury
    over the rank-``precond_rank`` Nyström factor U of K, built once:
    B ~= I + (sW U)(sW U)^T, so only the (r, r) Gram is rebuilt as W
    changes. ``precond_factor``: a prebuilt U (for example the state's
    ``U`` of an earlier fit on the same points, as
    :func:`laplace_fit_cg_segmented` passes), in which case no factor is
    built.

    ``tol`` defaults to 10 sqrt(eps) floored at ``cg_tol``: inexact Newton
    cannot resolve steps below its inner solve's error. ``compute_lml``
    estimates logdet(B) by stochastic Lanczos quadrature over the B matvec
    (probes from ``lml_generator``) and takes a = K^-1 f from the last
    Newton step, so it runs no extra step.
    """
    tol, max_iters = _newton_args(tol, max_iters, cfg)
    x_train = _k._dist._as_2d(x_train)
    n = x_train.shape[0]
    Kmv = _reg.kernel_operator(kernel, params, x_train, use_kernel,
                               _reg.cg_dot_mode(cg_tol))
    if precond_factor is not None:
        U = precond_factor
    else:
        k_nw, p_nw, _ = _k.split_white(kernel, params)
        U, _, _ = _nys.make_nystrom_factor(k_nw, p_nw, x_train, rank=min(precond_rank, n))
    dt = x_train.dtype
    y = _labels(y_train, x_train)
    t = (y + 1.0) / 2.0
    if tol is None:
        tol = max(_default_tol(dt), float(cg_tol))
    inner = 0

    def newton_step(f):
        nonlocal inner
        pi = torch.sigmoid(f)
        w = pi * (1.0 - pi)
        sw = torch.sqrt(w)
        b = w * f + (t - pi)
        st = _cg.cg_solve(_b_matvec(Kmv, sw), sw * Kmv(b), tol=cg_tol,
                          max_iters=cg_max_iters,
                          precond_apply=woodbury_apply(sw.to(U.dtype)[:, None] * U))
        inner += st.iters
        a = b - sw * st.x
        return Kmv(a), a

    f0 = torch.zeros(n, dtype=dt, device=x_train.device) if f_init is None else _labels(
        f_init, x_train)
    f, extra, iters, err, trace = _iterate(newton_step, f0, tol, max_iters, _rel_step)
    pi = torch.sigmoid(f)
    sw = torch.sqrt(pi * (1.0 - pi))
    if compute_lml:
        # f = K a from the last step, so a = K^-1 f with no further solve
        a = extra[0] if extra else newton_step(f)[1]
        logdet_B = _ls.slq_logdet_matvec(
            _b_matvec(Kmv, sw), n, _lml_generator(lml_generator, x_train.device),
            num_probes=lml_probes, lanczos_iters=lml_lanczos_iters, dtype=dt,
            device=x_train.device,
        )
        lml = -0.5 * torch.dot(a, f) + _log_sigmoid_likelihood(y, f) - 0.5 * logdet_B
    else:
        lml = torch.tensor(float("nan"), dtype=dt, device=x_train.device)
    return BinaryLaplaceCGState(f_mode=f, grad_at_mode=t - pi, sqrt_w=sw, U=U, lml=lml,
                                iters=iters, inner_iters=inner, converged=err <= tol,
                                error_trace=trace)


@torch.no_grad()
def laplace_fit_cg_segmented(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: int = 100,
    newton_per_call: int = 1,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    use_kernel: Optional[bool] = None,
    checkpoint_cb=None,
    resume_f: Optional[torch.Tensor] = None,
) -> BinaryLaplaceCGState:
    """Matrix-free Laplace fit as a loop of bounded calls, the
    classification twin of ``gp.posterior_cg_segmented``.

    Each call of :func:`laplace_fit_cg` runs ``newton_per_call`` Newton
    steps from the carried iterate (``f_init``; the Newton iterate is the
    whole state, so a restart loses nothing), on one Nyström factor U built
    here once (``precond_factor``). ``checkpoint_cb(steps_total, f)``
    receives the iterate after every call, and ``resume_f`` continues a
    stopped fit from it. Convergence is the same relative ||f_new - f||
    criterion, checked between calls; ``tol`` defaults to 10 sqrt(eps) of
    the inputs' dtype.
    """
    x_train = _k._dist._as_2d(x_train)
    n = x_train.shape[0]
    if tol is None:
        tol = _default_tol(x_train.dtype)
    k_nw, p_nw, _ = _k.split_white(kernel, params)
    U, _, _ = _nys.make_nystrom_factor(k_nw, p_nw, x_train, rank=min(precond_rank, n))
    f = (torch.zeros(n, dtype=x_train.dtype, device=x_train.device) if resume_f is None
         else _labels(resume_f, x_train))
    total = inner_total = 0
    err = math.inf
    trace = []
    state = None
    while total < max_iters:
        state = laplace_fit_cg(
            kernel, params, x_train, y_train,
            tol=0.0,  # always run the full newton_per_call budget
            max_iters=newton_per_call, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
            use_kernel=use_kernel, f_init=f, precond_factor=U,
        )
        err = float(_rel_step(state.f_mode, f))
        total += state.iters
        inner_total += state.inner_iters
        trace.append(err)
        f = state.f_mode
        if checkpoint_cb is not None:
            checkpoint_cb(total, f)
        if err <= tol:
            break
    error_trace = torch.full((max_iters,), float("nan"), dtype=f.dtype, device=f.device)
    error_trace[:len(trace)] = torch.tensor(trace, dtype=f.dtype)
    return BinaryLaplaceCGState(f_mode=f, grad_at_mode=state.grad_at_mode,
                                sqrt_w=state.sqrt_w, U=U, lml=state.lml, iters=total,
                                inner_iters=inner_total, converged=err <= tol,
                                error_trace=error_trace)


@torch.no_grad()
def predict_binary_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    state: BinaryLaplaceCGState,
    x_train: torch.Tensor,
    x_test: torch.Tensor,
    *,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    test_chunk: int = 512,
    use_kernel: Optional[bool] = None,
) -> BinaryPrediction:
    """Matrix-free batched Alg. 3.2 prediction at large n.

    mean = K_s^T (t - pi) as the dense path; the latent variance's
    v^T v = (sW K_s)^T B^{-1} (sW K_s) replaces the triangular solve with
    one preconditioned block-CG solve per ``test_chunk`` columns (every
    column rides the same kernel sweep: K2 on fp32 CUDA inputs). Each chunk
    of K_s is a cross-gram from the tile gram.
    [ref: GP_binary_classification.py:136-154]
    """
    x_train = _k._dist._as_2d(x_train)
    x_test = _k._dist._as_2d(x_test)
    m = x_test.shape[0]
    Kmv = _reg.kernel_operator(kernel, params, x_train, use_kernel,
                               _reg.cg_dot_mode(cg_tol))
    sw = state.sqrt_w
    Bmv = _b_matvec(Kmv, sw)
    apply = woodbury_apply(sw.to(state.U.dtype)[:, None] * state.U)
    kss = _k.gram_diag(kernel, params, x_test)
    chunk = min(test_chunk, m)
    means, variances = [], []
    for c0 in range(0, m, chunk):
        Ks = _kops.gram(kernel, params, x_train, x_test[c0:c0 + chunk])  # (n, chunk)
        means.append(Ks.T @ state.grad_at_mode)
        rhs = sw[:, None] * Ks
        st = _cg.cg_solve(Bmv, rhs, tol=cg_tol, max_iters=cg_max_iters, precond_apply=apply)
        variances.append(kss[c0:c0 + chunk] - torch.sum(rhs * st.x, dim=0))
    var = torch.clamp(torch.cat(variances), min=0.0)
    return _prediction(torch.cat(means), var)
