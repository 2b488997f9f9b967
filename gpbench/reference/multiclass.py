"""Plain multi-class GP classification with the Laplace approximation and an
RBF kernel shared by the classes (R&W Alg. 3.3), and its class
probabilities at test points, in plain PyTorch.

This is what the benchmark holds the program's mode and probabilities
against, and, run in TF32 with the cell's own settings, its control. It
imports torch and the regression reference's kernel operator, conjugate
gradients and precisions (``gp.py``), and takes nothing the program made.

- Dense (:func:`dense_fit`, a few thousand points): Alg. 3.3 as written,
  with one Cholesky factor of B_c = I + D_c^1/2 K D_c^1/2 a class, E_c, and
  M = chol(sum_c E_c).
- Blocked (:func:`blocked_fit`, the cells' n): the same Newton step,
  f_new = (K^-1 + W)^-1 b with b = W f + y - pi, W = D - PI PI^T. With any
  factor W = R R^T the step is f_new = K (b - R z), z solving
  (I + R^T K R) z = R^T K b (Woodbury). This reference takes the closed-form
  factor R = (I - pi 1^T) D^1/2 at each point (R R^T = D - pi pi^T since
  sum_c pi_c = 1), so it needs no eigen-decomposition. The solve is CG on K
  entries taken by blocks of rows (``gp.RBFOperator``), preconditioned by
  Woodbury over its own Nyström factor K ~= Q Q^T on landmarks drawn at
  random from a fixed seed, built in float64.
- Prediction (:func:`probabilities`): softmax over classes of the latent
  means K(x, xs)^T (y - pi), the program's and the reference script's rule
  (GP_multi_classification.py:179-197). R&W Alg. 3.4 averages the softmax
  over the latent Gaussian instead; neither side here does.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from .gp import FLOAT64, TF32, Precision, RBFOperator, cg, mm  # noqa: F401  (TF32: callers)


class Settings(NamedTuple):
    """How a blocked fit is run: the oracle's (float64, tight, per column)
    or the control's (the cell's own tolerances, rank and stopping rule)."""

    prec: Precision
    newton_tol: float  # on ||f_new - f|| / (1 + ||f_new||)
    newton_max_iters: int
    cg_tol: float  # on the residual over the right-hand side's norm
    cg_max_iters: int
    rank: int  # the Nyström factor's landmarks
    criterion: str  # as ``gp.cg``'s
    landmark_seed: int


class Fit(NamedTuple):
    f: torch.Tensor  # (C, n) the mode
    pi: torch.Tensor  # (C, n) softmax of f over classes
    iters: int  # Newton steps
    cg_iters: List[int]  # each step's CG iterations (blocked mode)
    converged: bool  # the last Newton step under its tolerance
    solved: bool  # every CG solve stopped by its tolerance (blocked mode)


def one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype) -> torch.Tensor:
    """(C, n) targets from integer labels."""
    classes = torch.arange(num_classes, device=labels.device)[:, None]
    return (labels.long()[None, :] == classes).to(dtype)


def _rel_step(f_new: torch.Tensor, f: torch.Tensor) -> float:
    return float(torch.linalg.norm(f_new - f) / (1.0 + torch.linalg.norm(f_new)))


def _w_apply(pi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """W u = pi u - pi sum_c(pi_c u_c), for (C, n) stacks."""
    return pi * u - pi * torch.sum(pi * u, dim=0, keepdim=True)


def dense_fit(x: torch.Tensor, labels: torch.Tensor, num_classes: int, *, sigma: float,
              lengthscale: float, tol: float = 1e-12, max_iters: int = 100) -> Fit:
    """Newton to the mode by Alg. 3.3 with a dense float64 K, from f = 0."""
    x = x.to(torch.float64)
    n = x.shape[0]
    K = sigma ** 2 * torch.exp(-0.5 * torch.cdist(x, x) ** 2 / lengthscale ** 2)
    y = one_hot(labels, num_classes, torch.float64)
    eye = torch.eye(n, dtype=torch.float64, device=x.device)
    f = torch.zeros_like(y)
    for it in range(1, max_iters + 1):
        pi = torch.softmax(f, dim=0)
        es = []
        for c in range(num_classes):
            sd = torch.sqrt(pi[c])
            chol = torch.linalg.cholesky(eye + sd[:, None] * K * sd[None, :])
            inv = torch.cholesky_solve(torch.diag(sd), chol)  # B_c^-1 D_c^1/2
            es.append(sd[:, None] * inv)  # E_c = D_c^1/2 B_c^-1 D_c^1/2
        m = torch.linalg.cholesky(sum(es))
        b = _w_apply(pi, f) + y - pi
        c_vec = torch.stack([es[c] @ (K @ b[c]) for c in range(num_classes)])
        z = torch.cholesky_solve(torch.sum(c_vec, dim=0)[:, None], m)[:, 0]
        a = b - c_vec + torch.stack([es[c] @ z for c in range(num_classes)])
        f_new = (K @ a.T).T
        step = _rel_step(f_new, f)
        f = f_new
        if step <= tol:
            return Fit(f, torch.softmax(f, dim=0), it, [], True, True)
    return Fit(f, torch.softmax(f, dim=0), max_iters, [], False, True)


def _r(pi: torch.Tensor, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """R u at every point, R = (I - pi 1^T) D^1/2, s = sqrt(pi)."""
    return s * u - pi * torch.sum(s * u, dim=0, keepdim=True)


def _rt(pi: torch.Tensor, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """R^T u at every point."""
    return s * u - s * torch.sum(pi * u, dim=0, keepdim=True)


def _nystrom_factor(x: torch.Tensor, sigma: float, lengthscale: float, rank: int, seed: int,
                    jitter: float = 1e-8) -> torch.Tensor:
    """Q (n, rank) with K ~= Q Q^T on ``rank`` landmarks drawn at random
    from ``seed``, in float64."""
    x = x.to(torch.float64)
    n = x.shape[0]
    rank = min(rank, n)
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:rank].to(x.device)
    knm = RBFOperator(x, sigma, lengthscale, 0.0, FLOAT64).cross(x[idx])
    kmm = knm[idx]
    eye = torch.eye(rank, dtype=torch.float64, device=x.device)
    for attempt in range(10):
        chol, info = torch.linalg.cholesky_ex(kmm + jitter * sigma ** 2 * 10 ** attempt * eye)
        if int(info) == 0:
            return torch.linalg.solve_triangular(chol, knm.T, upper=False).T
    raise RuntimeError("the Nyström landmarks' kernel matrix is not positive definite")


def blocked_fit(x: torch.Tensor, labels: torch.Tensor, num_classes: int, *, sigma: float,
                lengthscale: float, settings: Settings) -> Fit:
    """Newton to the mode from f = 0 by the factor R = (I - pi 1^T) D^1/2
    (module docstring), every product in ``settings.prec``; the
    preconditioner in float64."""
    prec = settings.prec
    dt = prec.dtype
    op = RBFOperator(x, sigma, lengthscale, 0.0, prec)

    def kmv(u):  # K u_c for every class: one pass over K's blocks
        return op.matvec(u.T.contiguous()).T

    q = _nystrom_factor(x, sigma, lengthscale, settings.rank, settings.landmark_seed)
    r = q.shape[1]
    C = num_classes
    y = one_hot(labels, C, dt)
    f = torch.zeros_like(y)
    cg_iters: List[int] = []
    solved = True
    for it in range(1, settings.newton_max_iters + 1):
        pi = torch.softmax(f, dim=0)
        s = torch.sqrt(pi)
        # I + V^T V with V = R^T blockdiag(Q): its (c, d) block is
        # Q^T diag(W_cd) Q, W_cd = delta_cd pi_c - pi_c pi_d
        p64, s64 = pi.to(torch.float64), s.to(torch.float64)
        gram = torch.eye(C * r, dtype=torch.float64, device=q.device)
        for c in range(C):
            for d in range(c, C):
                w = (p64[c] if c == d else 0.0) - p64[c] * p64[d]
                block = q.T @ (w[:, None] * q)
                gram[c * r:(c + 1) * r, d * r:(d + 1) * r] += block
                if d != c:
                    gram[d * r:(d + 1) * r, c * r:(c + 1) * r] += block.T
        chol_g = torch.linalg.cholesky(gram)

        def precond(v, p64=p64, s64=s64, chol_g=chol_g):
            u = v[:, 0].reshape(C, -1).to(torch.float64)
            z = torch.cholesky_solve((_r(p64, s64, u) @ q).reshape(C * r, 1), chol_g)
            out = u - _rt(p64, s64, z.reshape(C, r) @ q.T)
            return out.reshape(-1, 1).to(v.dtype)

        def bmv(v, pi=pi, s=s):
            u = v[:, 0].reshape(C, -1)
            return (u + _rt(pi, s, kmv(_r(pi, s, u)))).reshape(-1, 1)

        b = _w_apply(pi, f) + y - pi
        rhs = _rt(pi, s, kmv(b)).reshape(-1, 1)
        sol = cg(bmv, rhs, precond, tol=settings.cg_tol, max_iters=settings.cg_max_iters,
                 criterion=settings.criterion)
        cg_iters.append(sol.iters)
        solved = solved and sol.converged
        a = b - _r(pi, s, sol.x[:, 0].reshape(C, -1))
        f_new = kmv(a)
        step = _rel_step(f_new, f)
        f = f_new
        if not math.isfinite(step):
            break
        if step <= settings.newton_tol:
            return Fit(f, torch.softmax(f, dim=0), it, cg_iters, True, solved)
    return Fit(f, torch.softmax(f, dim=0), len(cg_iters), cg_iters, False, solved)


def probabilities(x: torch.Tensor, labels: torch.Tensor, pi: torch.Tensor, xs: torch.Tensor, *,
                  sigma: float, lengthscale: float, prec: Precision) -> torch.Tensor:
    """(C, m) softmax over classes of K(x, xs)^T (y - pi) at ``xs``, for
    the (C, n) softmax ``pi`` of a mode."""
    op = RBFOperator(x, sigma, lengthscale, 0.0, prec)
    ks = op.cross(xs)
    resid = one_hot(labels, pi.shape[0], prec.dtype) - pi.to(prec.dtype)
    return torch.softmax(mm(resid, ks, prec), dim=0)
