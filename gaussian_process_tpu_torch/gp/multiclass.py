"""Multi-class GP classification with the Laplace approximation, R&W
Alg. 3.3 (torch counterpart of ``gp/multiclass.py``).

The latent f lives as a (C, n) tensor. The JAX package's ``vmap`` over
classes becomes a batch dimension: per-class factorizations are one batched
``torch.linalg.cholesky_ex`` on (C, n, n). The (Cn x Cn) matrices
W = D - PI PI^T and R = D^-1 PI of Alg. 3.3 are never materialised: their
actions reduce to row-wise products and class sums
[W u = pi u - pi sum_c(pi_c u_c); R^T u = sum_c u_c].

- Dense: :func:`laplace_fit_multiclass` (``mode="reference"`` reproduces the
  reference's damped trainer, quirks Q3/Q4), :func:`laplace_predict_multiclass`,
  :func:`fit_multiclass`, :func:`predict_multiclass`.
- Matrix-free: :func:`laplace_fit_multiclass_cg` solves the stacked
  B = I + W^{1/2} K W^{1/2} system by CG, every B matvec one kernel sweep
  with C right-hand sides; :func:`predict_multiclass_cg` needs cross-gram
  chunks only (the tile gram on fp32 CUDA inputs), never a solve.

Loops run under ``torch.no_grad()``, as in ``gp.classification``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.gp import classification as _cls
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.linalg import nystrom as _nys
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.opt import large_scale as _ls
from gaussian_process_tpu_torch.utils import profiling as _profiling


class MulticlassLaplaceState(NamedTuple):
    f_mode: torch.Tensor  # (C, n)
    pi: torch.Tensor  # (C, n) softmax probabilities at the mode
    lml: torch.Tensor  # scalar Laplace-approximate log marginal likelihood
    iters: int
    converged: bool
    error_trace: torch.Tensor  # (max_iters,) per-iteration error, NaN-padded


def _w_apply(pi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(D - PI PI^T) u for stacked u, both (C, n)."""
    return pi * u - pi * torch.sum(pi * u, dim=0, keepdim=True)


def _bmv(K: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K_c u_c for every class: K (C, n, m), u (C, m) -> (C, n)."""
    return (K @ u[..., None])[..., 0]


def _logsumexp_lml(a, f, y) -> torch.Tensor:
    """-1/2 a^T f + y^T f - sum_i log sum_c exp(f_ci): R&W 3.44 without
    its log-determinant."""
    return -0.5 * torch.sum(a * f) + torch.sum(y * f) - torch.sum(torch.logsumexp(f, dim=0))


@torch.no_grad()
def laplace_fit_multiclass(
    K: torch.Tensor,
    y: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    mode: str = "newton",
    cfg: Optional[_config.NewtonConfig] = None,
) -> MulticlassLaplaceState:
    """Newton to the softmax-Laplace mode (Alg. 3.3). ``cfg`` supplies
    tol/max_iters defaults; explicit arguments win.

    ``K``: (C, n, n) per-class prior blocks (an expanded view of one block
    is fine). ``y``: (C, n) one-hot targets.

    ``mode="reference"`` reproduces the trainer the reference runs
    (``model_training2`` [ref: GP_multi_classification.py:129-176]): its
    sign quirk Q4 (``+ y + pi``), the s = 3 ridge, the 1e-4 damping and its
    half-solve update; only the stride-60 hard-coding (Q3) is generalised.
    """
    tol, max_iters = _cls._newton_args(tol, max_iters, cfg)
    if mode == "reference":
        return _laplace_fit_multiclass_reference(K, y, tol=tol, max_iters=max_iters)
    if mode != "newton":
        raise ValueError(f"unknown mode {mode!r} (expected 'newton' or 'reference')")
    y = y.to(device=K.device, dtype=K.dtype)
    C, n = y.shape
    if tol is None:
        tol = _cls._default_tol(K.dtype)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)

    def step(f):
        pi = torch.softmax(f, dim=0)
        sw = torch.sqrt(pi)  # D = diag(pi) per class: sqrt(D_c) = sqrt(pi_c)
        B = sw[:, :, None] * K * sw[:, None, :]
        B.diagonal(dim1=-2, dim2=-1).add_(1.0)
        Ls = torch.linalg.cholesky_ex(B).L  # (C, n, n)
        # V_c = L_c^{-1} sW_c, so that E_c = sW_c B_c^{-1} sW_c = V_c^T V_c:
        # one triangular solve per class, then every E_c apply is two GEMVs
        Vs = _chol.tri_solve(Ls, eye.expand(C, n, n)) * sw[:, None, :]
        e_apply = lambda u: _bmv(Vs.mT, _bmv(Vs, u))  # noqa: E731

        b = _w_apply(pi, f) + y - pi  # b = W f + grad  [Alg 3.3 line 7]
        c_vec = e_apply(_bmv(K, b))  # c = E K b
        # M = chol(sum_c E_c); sum_c V_c^T V_c is one GEMM over the stacked V
        Vflat = Vs.reshape(C * n, n)
        M = torch.linalg.cholesky_ex(Vflat.T @ Vflat).L
        m_sol = _chol.cholesky_solve(M, torch.sum(c_vec, dim=0))  # R^T c
        a = b - c_vec + e_apply(m_sol.expand(C, n))
        return _bmv(K, a), a, Ls, M, pi

    f0 = torch.zeros_like(y)
    f, _, iters, err, trace = _cls._iterate(step, f0, tol, max_iters, _cls._rel_step)
    # the mode's artifacts at the converged f. The logdet of the stacked
    # system is log|I + W^{1/2} K W^{1/2}| = sum_c log|B_c| + log|sum_c E_c|:
    # M = chol(sum_c E_c) carries the second half (R&W 3.44).
    _, a, Ls, M, pi = step(f)
    lml = (
        _logsumexp_lml(a, f, y)
        - torch.sum(torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1)))
        - torch.sum(torch.log(torch.diagonal(M)))
    )
    return MulticlassLaplaceState(f_mode=f, pi=pi, lml=lml, iters=iters, converged=err <= tol,
                                  error_trace=trace)


def _laplace_fit_multiclass_reference(
    K: torch.Tensor,
    y: torch.Tensor,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    ridge: float = 3.0,
    step_size: float = 1e-4,
) -> MulticlassLaplaceState:
    """The reference's damped trainer2, reproduced as written; see
    :func:`laplace_fit_multiclass`. Dense (Cn, Cn) algebra like the
    reference's [ref: GP_multi_classification.py:129-176]: fine at its
    workload scale (blobs: Cn = 180)."""
    if tol is None:
        tol = 0.01  # [ref: GP_multi_classification.py:138]
    if max_iters is None:
        max_iters = 10000  # [ref: :146]
    y = y.to(device=K.device, dtype=K.dtype)
    C, n = y.shape
    N = C * n
    # stacked block-diagonal prior, class-major like the reference's
    # scipy block_diag [ref: :232-238]
    K_full = torch.block_diag(*K)
    yv = y.reshape(N)
    eyeN = torch.eye(N, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky_ex(ridge * eyeN + K_full).L  # [ref: :148]
    A_inv = _chol.cholesky_solve(L, eyeN)  # (s I + K)^{-1} [ref: :149,154]
    idx = torch.arange(n, device=K.device)

    def w_full(piv):
        # W = diag(pi) - PI PI^T with PI = row-stacked diag(pi_c) [ref: :150-152]
        pi_cn = piv.reshape(C, n)
        PiPiT = torch.zeros((N, N), dtype=K.dtype, device=K.device)
        for c in range(C):
            for d in range(C):
                PiPiT[c * n + idx, d * n + idx] = pi_cn[c] * pi_cn[d]
        return torch.diag(piv) - PiPiT

    piv = torch.zeros(N, dtype=K.dtype, device=K.device)

    def step(f):
        nonlocal piv
        piv = torch.softmax(f.reshape(C, n), dim=0).reshape(N)
        W = w_full(piv)
        L_sd = torch.linalg.cholesky_ex(ridge * eyeN + A_inv + W).L  # [ref: :154-155]
        # quirk Q4 reproduced: "+ yv + piv" (Alg 3.3 has y - pi) and the
        # half-solve f <- L_sd^{-1} (...) [ref: :157-158]
        rhs = ((1.0 - step_size) * A_inv + W) @ f + yv + piv
        return (_chol.tri_solve(L_sd, rhs),)

    f, _, iters, err, trace = _cls._iterate(
        step, torch.zeros(N, dtype=K.dtype, device=K.device), tol, max_iters,
        lambda f_new, f: torch.linalg.norm(f_new - f),  # [ref: :159]
    )
    # the reference returns pi at the PREVIOUS iterate, computed at the top
    # of the final loop body [ref: :149,176]
    return MulticlassLaplaceState(
        f_mode=f.reshape(C, n), pi=piv.reshape(C, n),
        lml=torch.tensor(float("nan"), dtype=K.dtype, device=K.device),  # none in the reference
        iters=iters, converged=err <= tol, error_trace=trace,
    )


# ------------------------------------------------- matrix-free (large n)


class MulticlassLaplaceCGState(NamedTuple):
    """Softmax-Laplace mode artifacts without any n x n factor: the
    large-n counterpart of :class:`MulticlassLaplaceState`."""

    f_mode: torch.Tensor  # (C, n)
    pi: torch.Tensor  # (C, n)
    lml: torch.Tensor  # SLQ-estimated (NaN unless compute_lml)
    iters: int
    inner_iters: int  # total CG iterations across Newton steps
    converged: bool
    error_trace: torch.Tensor
    # each Newton step's CG iterations, summing to inner_iters; a step that
    # reached cg_max_iters stopped at its cap, not by cg_tol. Empty for a
    # state converted from one that did not record them
    cg_iters: Tuple[int, ...] = ()


def _w_blocks(pi: torch.Tensor) -> torch.Tensor:
    """The per-point blocks W_i = diag(p_i) - p_i p_i^T, (n, C, C): the
    stacked W of Alg. 3.3 couples classes only within a point."""
    P = pi.T  # (n, C)
    return torch.diag_embed(P) - P[:, :, None] * P[:, None, :]


# points per batched eigh: cuSOLVER's batched syev (torch 2.11 with CUDA
# 12.8 on the H100) refuses 32768 or more 3 x 3 matrices in one call
# (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size query); 16384 works
EIGH_BATCH = 16384


def _w_sqrt_blocks(pi: torch.Tensor) -> torch.Tensor:
    """Per-point PSD square roots of W (n, C, C): n batched (C, C) eigh's in
    batches of ``EIGH_BATCH``, O(n C^3), trivial next to one kernel
    matvec."""
    with _profiling.span("gp.laplace.w_roots"):
        W = _w_blocks(pi)
        roots = []
        for i in range(0, W.shape[0], EIGH_BATCH):
            evals, evecs = torch.linalg.eigh(W[i:i + EIGH_BATCH])
            root = torch.sqrt(torch.clamp(evals, min=0.0))
            roots.append((evecs * root[:, None, :]) @ evecs.mT)
        return torch.cat(roots)


def _w_half_apply(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """W^{1/2} u for stacked u (C, n): per-point (C, C) matvecs."""
    return (S @ u.T[:, :, None])[:, :, 0].T


def _coupled_woodbury(pi: torch.Tensor, S: torch.Tensor, U: torch.Tensor):
    """The full-coupling Woodbury preconditioner of the stacked B.

    With K ~= blockdiag(U U^T) over classes, B ~= I + V V^T where
    V = W^{1/2} blockdiag(U) is (Cn, Cr). Its (Cr, Cr) Gram has the closed
    form (V^T V)[(c,j),(d,k)] = sum_i W_i[c,d] U[i,j] U[i,k]: one
    W-weighted Gram of U per class pair, C(C+1)/2 GEMMs. Built and applied
    in U's dtype (float64 for fp32 inputs): the apply cancels as the binary
    path's does (``classification.woodbury_apply``)."""
    C = pi.shape[0]
    r = U.shape[1]
    dt = U.dtype
    with _profiling.span("gp.laplace.precond_build"):
        Wm = _w_blocks(pi.to(dt))
        G = torch.eye(C * r, dtype=dt, device=U.device)
        for c in range(C):
            for d in range(c, C):
                block = U.T @ (Wm[:, c, d, None] * U)
                G[c * r:(c + 1) * r, d * r:(d + 1) * r] += block
                if d != c:
                    G[d * r:(d + 1) * r, c * r:(c + 1) * r] += block.T
        chol_G = _chol.safe_cholesky(G).factor
        S64 = S.to(dt)

    def apply(u_flat):
        with _profiling.span("gp.solvers.nystrom_apply"):
            u = u_flat.reshape(C, -1).to(dt)
            w = _w_half_apply(S64, u) @ U  # (C, r)
            z = _chol.cholesky_solve(chol_G, w.reshape(C * r)).reshape(C, r)
            out = u - _w_half_apply(S64, z @ U.T)
            return out.reshape(-1).to(u_flat.dtype)

    return apply


def _stacked_b(Kmv, S: torch.Tensor, C: int):
    """u -> (I + W^{1/2} K W^{1/2}) u on flat (C n,) vectors."""

    def Bmv(u_flat):
        u = u_flat.reshape(C, -1)
        return (u + _w_half_apply(S, Kmv(_w_half_apply(S, u)))).reshape(-1)

    return Bmv


@torch.no_grad()
def laplace_fit_multiclass_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_labels: torch.Tensor,
    num_classes: int,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    use_kernel: Optional[bool] = None,
    f_init: Optional[torch.Tensor] = None,
    compute_lml: bool = False,
    lml_probes: int = 8,
    lml_lanczos_iters: int = 32,
    lml_generator: Optional[torch.Generator] = None,
    cfg: Optional[_config.NewtonConfig] = None,
) -> MulticlassLaplaceCGState:
    """True-Newton softmax-Laplace fit with matrix-free inner solves.

    Each step solves the stacked symmetric system once by CG through

        a = b - W^{1/2} B^{-1} W^{1/2} K b,
        B = I + W^{1/2} K W^{1/2},     b = W f + (y - pi),

    with W^{1/2} the per-point (C, C) PSD root. Every B matvec is one kernel
    sweep with C right-hand sides (all classes share K: K3 at r = C on fp32
    CUDA inputs) plus per-point (C, C) products. The preconditioner is the
    full-coupling Woodbury over a rank-``precond_rank`` Nyström factor of K
    (:func:`_coupled_woodbury`). ``tol`` defaults to 10 sqrt(eps) floored
    at ``cg_tol``; ``compute_lml`` estimates the stacked logdet by SLQ and
    takes a = K^-1 f from the last Newton step (no extra step).
    """
    with _profiling.span("gp.laplace.fit"):
        tol, max_iters = _cls._newton_args(tol, max_iters, cfg)
        x_train = _k._dist._as_2d(x_train)
        n = x_train.shape[0]
        C = int(num_classes)
        Kmv_cols = _reg.kernel_operator(kernel, params, x_train, use_kernel,
                                        _reg.cg_dot_mode(cg_tol))
        Kmv = lambda u: Kmv_cols(u.T).T  # noqa: E731  (C, n) -> (C, n), one sweep
        k_nw, p_nw, _ = _k.split_white(kernel, params)
        with _profiling.span("gp.solvers.nystrom_build"):
            U, _, _ = _nys.make_nystrom_factor(k_nw, p_nw, x_train, rank=min(precond_rank, n))
        dt = x_train.dtype
        y = one_hot_targets(y_labels, C, dtype=dt).to(x_train.device)
        if tol is None:
            tol = max(_cls._default_tol(dt), float(cg_tol))
        cg_iters = []

        def newton_step(f):
            pi = torch.softmax(f, dim=0)
            S = _w_sqrt_blocks(pi)
            b = _w_apply(pi, f) + y - pi
            rhs = _w_half_apply(S, Kmv(b)).reshape(C * n)
            st = _cg.cg_solve(_stacked_b(Kmv, S, C), rhs, tol=cg_tol, max_iters=cg_max_iters,
                              precond_apply=_coupled_woodbury(pi, S, U))
            cg_iters.append(st.iters)
            a = b - _w_half_apply(S, st.x.reshape(C, n))
            return Kmv(a), a

        f0 = torch.zeros((C, n), dtype=dt, device=x_train.device) if f_init is None else \
            torch.as_tensor(f_init).to(device=x_train.device, dtype=dt)
        f, extra, iters, err, trace = _cls._iterate(newton_step, f0, tol, max_iters,
                                                    _cls._rel_step)
        pi = torch.softmax(f, dim=0)
        if compute_lml:
            # f = K a from the last step, so a = K^-1 f with no further solve
            a = extra[0] if extra else newton_step(f)[1]
            logdet_B = _ls.slq_logdet_matvec(
                _stacked_b(Kmv, _w_sqrt_blocks(pi), C), C * n,
                _cls._lml_generator(lml_generator, x_train.device), num_probes=lml_probes,
                lanczos_iters=lml_lanczos_iters, dtype=dt, device=x_train.device,
            )
            # R&W 3.44 with log|I + W^{1/2} K W^{1/2}| estimated by SLQ
            lml = _logsumexp_lml(a, f, y) - 0.5 * logdet_B
        else:
            lml = torch.tensor(float("nan"), dtype=dt, device=x_train.device)
        return MulticlassLaplaceCGState(f_mode=f, pi=pi, lml=lml, iters=iters,
                                        inner_iters=sum(cg_iters), converged=err <= tol,
                                        error_trace=trace, cg_iters=tuple(cg_iters))


class MulticlassPrediction(NamedTuple):
    mean: torch.Tensor  # (C, m) latent class means
    prob: torch.Tensor  # (C, m) softmax of the latent means
    label: torch.Tensor  # (m,) argmax class


def _prediction(mean: torch.Tensor) -> MulticlassPrediction:
    return MulticlassPrediction(mean=mean, prob=torch.softmax(mean, dim=0),
                                label=torch.argmax(mean, dim=0))


@torch.no_grad()
def predict_multiclass_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    state: MulticlassLaplaceCGState,
    x_train: torch.Tensor,
    y_labels: torch.Tensor,
    x_test: torch.Tensor,
    num_classes: int,
    *,
    test_chunk: int = 2048,
) -> MulticlassPrediction:
    """Matrix-free multiclass mean prediction at large n: the reference's
    metric uses only f_bar*_c = K_s_c^T (y_c - pi_c) and argmax
    [ref: GP_multi_classification.py:179-197], which needs cross-gram
    chunks (the tile gram on fp32 CUDA inputs), never a solve:
    O(n * test_chunk) memory."""
    with _profiling.span("gp.laplace.predict"):
        x_train = _k._dist._as_2d(x_train)
        x_test = _k._dist._as_2d(x_test)
        y = one_hot_targets(y_labels, num_classes, dtype=state.f_mode.dtype).to(x_train.device)
        resid = y - state.pi  # (C, n)
        chunk = min(test_chunk, x_test.shape[0])
        means = [resid @ _kops.gram(kernel, params, x_train, x_test[c0:c0 + chunk])
                 for c0 in range(0, x_test.shape[0], chunk)]
        return _prediction(torch.cat(means, dim=1))


def laplace_predict_multiclass(
    state: MulticlassLaplaceState, y: torch.Tensor, K_s: torch.Tensor
) -> MulticlassPrediction:
    """Batched mean prediction: f_bar*_c = K_s_c^T (y_c - pi_c), argmax
    over c [ref: GP_multi_classification.py:179-197]. ``K_s``: (C, n, m)
    per-class cross-covariances (an expanded view of one block is fine)."""
    resid = y.to(device=K_s.device, dtype=K_s.dtype) - state.pi
    return _prediction(_bmv(K_s.mT, resid))


def one_hot_targets(y_labels, num_classes: int, *, dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """(C, n) one-hot matrix from integer labels (the default float dtype
    unless ``dtype``): generalises the reference's ``y_train * 60 + index``
    indexing (quirk Q3) [ref: GP_multi_classification.py:239-243]."""
    labels = torch.as_tensor(y_labels).long()
    out = torch.nn.functional.one_hot(labels, num_classes).T
    return out.to(dtype or torch.get_default_dtype())


def fit_multiclass(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_labels: torch.Tensor,
    num_classes: int,
    *,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    dist_method: str = "dot",
    mode: str = "newton",
    cfg: Optional[_config.NewtonConfig] = None,
) -> MulticlassLaplaceState:
    """Shared-kernel wrapper: every class gets the same block (the reference
    gives every class the same RBF block [ref: GP_multi_classification.py:232-238])."""
    Kc = _kops.gram(kernel, params, x_train, method=dist_method)
    K = Kc.expand((num_classes,) + Kc.shape)
    y = one_hot_targets(y_labels, num_classes, dtype=Kc.dtype)
    return laplace_fit_multiclass(K, y, tol=tol, max_iters=max_iters, mode=mode, cfg=cfg)


def predict_multiclass(
    kernel: _k.Kernel,
    params: _k.Params,
    state: MulticlassLaplaceState,
    x_train: torch.Tensor,
    y_labels: torch.Tensor,
    x_test: torch.Tensor,
    num_classes: int,
    *,
    dist_method: str = "dot",
) -> MulticlassPrediction:
    K_s = _kops.gram(kernel, params, x_train, x_test, method=dist_method)
    y = one_hot_targets(y_labels, num_classes, dtype=K_s.dtype)
    return laplace_predict_multiclass(state, y, K_s.expand((num_classes,) + K_s.shape))
