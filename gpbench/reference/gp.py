"""Plain GP regression with an RBF kernel: the posterior at test points and
the matrix-free LML surrogate's Adam steps, in plain PyTorch.

This is what the benchmark holds the program's answers against, and, run
in a lower precision with the cell's own settings, its control. It imports
torch alone and takes nothing the program made: it evaluates the kernel
entries itself, builds its own Nyström preconditioner and solves with its
own conjugate gradients.

- K(a, b) = sigma^2 exp(e), e = -|a - b|^2 / (2 l^2), written as one
  product of augmented rows: e_ij = <a~_i, b~_j> with
  a~ = [a / l, -|a / l|^2 / 2, 1] and b~ = [b / l, 1, -|b / l|^2 / 2], so a
  block of K is one matrix product and one exp. Points are centred first.
- K @ V streams blocks of rows, so K (84 GB in float64 at n = 102400) is
  never held.
- CG on the block [b_1 | b_2 | ...] with per-column step sizes and a
  rank-r Nyström preconditioner (P = U U^T + s I, Woodbury), always built
  in float64: it only changes how fast CG converges, not what it converges
  to.

``Precision``: ``FLOAT64`` computes everything in float64. ``TF32`` is the
control: float32 arithmetic with every matrix product in TF32 (operands
with 10 mantissa bits), on the card's TF32 tensor cores where the tensors
are on the card, else with the operands rounded to TF32 and multiplied in
float32; the preconditioner stays float64.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, NamedTuple, Sequence

import torch


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool  # every matrix product in TF32


FLOAT64 = Precision(torch.float64, False)
TF32 = Precision(torch.float32, True)

# entries of K a block of rows may hold (2 GiB in float64)
BLOCK_ELEMENTS = 1 << 28


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _tf32_products():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """a @ b in ``prec``; TF32 on the card's tensor cores, elsewhere by
    rounding both operands first."""
    if not prec.tf32:
        return a @ b
    if a.is_cuda:
        with _tf32_products():
            return a @ b
    return tf32_round(a) @ tf32_round(b)


class RBFOperator:
    """K(x, x) + noise I for an RBF kernel, applied by blocks of rows."""

    def __init__(self, x: torch.Tensor, sigma: float, lengthscale: float, noise: float,
                 prec: Precision):
        self.prec = prec
        x = x.to(prec.dtype)
        self.center = x.mean(dim=0, keepdim=True)
        self.x = x - self.center
        self.n = x.shape[0]
        self.sigma2 = float(sigma) ** 2
        self.lengthscale = float(lengthscale)
        self.noise = float(noise)
        self.rows_a, self.rows_b = self._augment(self.x)
        self.block = max(64, BLOCK_ELEMENTS // self.n)

    def _augment(self, x: torch.Tensor):
        xs = x / self.lengthscale
        h = -0.5 * (xs * xs).sum(dim=1, keepdim=True)
        one = torch.ones_like(h)
        return torch.cat([xs, h, one], dim=1), torch.cat([xs, one, h], dim=1)

    def exponent(self, a_rows: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
        """e = -|a - b|^2 / (2 l^2) for augmented rows, at most 0."""
        return torch.clamp(mm(a_rows, b_rows.T, self.prec), max=0.0)

    def cross(self, xs: torch.Tensor) -> torch.Tensor:
        """K(x, xs), n x m."""
        _, b = self._augment(xs.to(self.prec.dtype) - self.center)
        out = torch.empty((self.n, xs.shape[0]), dtype=self.prec.dtype, device=self.x.device)
        for i in range(0, self.n, self.block):
            out[i:i + self.block] = self.sigma2 * torch.exp(
                self.exponent(self.rows_a[i:i + self.block], b))
        return out

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """(K + noise I) v for v of n x k."""
        out = torch.empty_like(v)
        for i in range(0, self.n, self.block):
            blk = torch.exp_(self.exponent(self.rows_a[i:i + self.block], self.rows_b))
            out[i:i + self.block] = self.sigma2 * mm(blk, v, self.prec)
        return out + self.noise * v

    def grad_products(self, v: torch.Tensor):
        """(K v, (K * S) v) with S = |a - b|^2 / l^2, so that dK/dlog(sigma)
        = 2 K and dK/dlog(l) = K * S."""
        kv = torch.empty_like(v)
        ksv = torch.empty_like(v)
        for i in range(0, self.n, self.block):
            e = self.exponent(self.rows_a[i:i + self.block], self.rows_b)
            k = torch.exp(e)
            kv[i:i + self.block] = self.sigma2 * mm(k, v, self.prec)
            ksv[i:i + self.block] = -2.0 * self.sigma2 * mm(k.mul_(e), v, self.prec)
            del e, k
        return kv, ksv


class Nystrom:
    """P^{-1} for P = U U^T + s I, the rank-``rank`` Nyström approximation of
    K plus the noise, on evenly strided landmarks, in float64."""

    def __init__(self, op: RBFOperator, rank: int, jitter: float = 1e-6):
        x = op.x.to(torch.float64)
        n = x.shape[0]
        rank = min(rank, n)
        idx = torch.arange(rank, device=x.device) * (n // rank)
        exact = RBFOperator(x, math.sqrt(op.sigma2), op.lengthscale, op.noise, FLOAT64)
        knm = exact.cross(x[idx])
        kmm = knm[idx]
        eye = torch.eye(rank, dtype=torch.float64, device=x.device)
        for attempt in range(8):
            chol, info = torch.linalg.cholesky_ex(kmm + jitter * op.sigma2 * 10 ** attempt * eye)
            if int(info) == 0:
                break
        else:
            raise RuntimeError("the Nyström landmarks' kernel matrix is not positive definite")
        self.u = torch.linalg.solve_triangular(chol, knm.T, upper=False).T
        del knm, kmm
        self.shift = op.noise
        self.chol_g = torch.linalg.cholesky(self.shift * eye + self.u.T @ self.u)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        rr = r.to(torch.float64)
        z = torch.cholesky_solve(self.u.T @ rr, self.chol_g)
        return ((rr - self.u @ z) / self.shift).to(r.dtype)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    converged: bool


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       precond: Callable[[torch.Tensor], torch.Tensor], *, tol: float, max_iters: int,
       criterion: str) -> CGResult:
    """Preconditioned CG on the columns of b at once, each column with its own
    step sizes. It stops where ``criterion`` holds: "column", every column's
    residual at most ``tol`` times its own right-hand side's norm; "worst",
    the largest residual at most ``tol`` times the largest right-hand side
    norm (the stopping rule of the program under test)."""
    bnorm = torch.sqrt(torch.sum(b * b, dim=0))
    if criterion == "column":
        stop = tol * bnorm
    elif criterion == "worst":
        stop = tol * torch.max(bnorm) * torch.ones_like(bnorm)
    else:
        raise ValueError(f"unknown criterion {criterion!r}")
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z.clone()
    rz = torch.sum(r * z, dim=0)
    for it in range(max_iters + 1):
        rnorm = torch.sqrt(torch.sum(r * r, dim=0))
        done = bool(torch.all(rnorm <= stop)) if criterion == "column" else \
            bool(torch.max(rnorm) <= stop[0])
        if done or it == max_iters or not bool(torch.all(torch.isfinite(rnorm))):
            return CGResult(x, it, done)
        ap = matvec(p)
        pap = torch.sum(p * ap, dim=0)
        alpha = rz / torch.where(pap == 0, torch.ones_like(pap), pap)
        x += alpha * p
        r -= alpha * ap
        z = precond(r)
        rz_new = torch.sum(r * z, dim=0)
        p = z + (rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)) * p
        rz = rz_new
    raise AssertionError("unreachable")


class Settings(NamedTuple):
    """How a solve is run: the oracle's (float64, tight, per column) or the
    control's (the cell's own tolerance, rank and stopping rule)."""

    prec: Precision
    tol: float
    rank: int
    max_iters: int
    criterion: str


class Posterior(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    iters: int
    converged: bool


def posterior(x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor, *, sigma: float,
              lengthscale: float, noise: float, settings: Settings) -> Posterior:
    """Mean and latent variance at ``xs``: alpha and U = A^{-1} K(x, xs) from
    one block solve of [y | K(x, xs)], A = K + noise I;
    mean = K(x, xs)^T alpha, var = sigma^2 - colsum(K(x, xs) * U)."""
    prec = settings.prec
    op = RBFOperator(x, sigma, lengthscale, noise, prec)
    pre = Nystrom(op, settings.rank)
    ks = op.cross(xs)
    rhs = torch.cat([y.to(prec.dtype)[:, None], ks], dim=1)
    sol = cg(op.matvec, rhs, pre.apply, tol=settings.tol, max_iters=settings.max_iters,
             criterion=settings.criterion)
    alpha, u = sol.x[:, 0], sol.x[:, 1:]
    mean = mm(ks.T, alpha[:, None], prec)[:, 0]
    var = op.sigma2 - torch.sum(ks * u, dim=0)
    return Posterior(mean, var, sol.iters, sol.converged)


class Training(NamedTuple):
    values: List[float]  # the surrogate at each step's params
    params: List[dict]  # {"sigma", "lengthscale"} after each step
    grads: List[List[float]]  # d surrogate / d (log sigma, log l) at each step
    iters: List[int]
    converged: bool


def train(x: torch.Tensor, y: torch.Tensor, start: dict, probes: Sequence[torch.Tensor], *,
          noise: float, learning_rate: float, settings: Settings,
          betas=(0.9, 0.999), eps: float = 1e-8) -> Training:
    """Adam ascent on the LML surrogate in log space, one step per probe
    block in ``probes`` (n x P Rademacher columns):

        surrogate = -1/2 (2 y^T alpha - alpha^T A alpha)
                    - 1/2 mean_i w_i^T A z_i - n/2 log(2 pi)

    with [alpha | W] = A^{-1} [y | Z] at the step's params. Its gradient in
    theta = log(param), alpha and W held fixed, is
    +1/2 alpha^T dA alpha - 1/2 mean_i w_i^T dA z_i."""
    prec = settings.prec
    n = x.shape[0]
    yy = y.to(prec.dtype)
    theta = torch.log(torch.tensor([start["sigma"], start["lengthscale"]], dtype=torch.float64))
    m = torch.zeros(2, dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.float64)
    values, params, grads, iters = [], [], [], []
    converged = True
    for t, z in enumerate(probes, start=1):
        sigma, ell = (float(a) for a in torch.exp(theta))
        op = RBFOperator(x, sigma, ell, noise, prec)
        pre = Nystrom(op, settings.rank)
        zz = z.to(prec.dtype)
        sol = cg(op.matvec, torch.cat([yy[:, None], zz], dim=1), pre.apply, tol=settings.tol,
                 max_iters=settings.max_iters, criterion=settings.criterion)
        converged = converged and sol.converged
        alpha, w = sol.x[:, 0], sol.x[:, 1:]
        vv = torch.cat([alpha[:, None], zz], dim=1)
        kv, ksv = op.grad_products(vv)
        av = kv + noise * vv
        quad = -0.5 * (2.0 * torch.dot(yy, alpha) - torch.dot(alpha, av[:, 0]))
        logdet = -0.5 * torch.mean(torch.sum(w * av[:, 1:], dim=0))
        values.append(float(quad + logdet) - 0.5 * n * math.log(2.0 * math.pi))

        def bilinear(d):
            return 0.5 * torch.dot(alpha, d[:, 0]) - 0.5 * torch.mean(torch.sum(w * d[:, 1:], dim=0))

        g = torch.tensor([float(bilinear(2.0 * kv)), float(bilinear(ksv))], dtype=torch.float64)
        grads.append([float(a) for a in g])
        iters.append(sol.iters)
        # torch.optim.Adam's rule on the loss -surrogate
        loss_grad = -g
        m = betas[0] * m + (1 - betas[0]) * loss_grad
        v = betas[1] * v + (1 - betas[1]) * loss_grad * loss_grad
        denom = torch.sqrt(v) / math.sqrt(1 - betas[1] ** t) + eps
        theta = theta - (learning_rate / (1 - betas[0] ** t)) * m / denom
        sigma, ell = (float(a) for a in torch.exp(theta))
        params.append({"sigma": sigma, "lengthscale": ell})
        del op, pre, sol, kv, ksv, av
    return Training(values, params, grads, iters, converged)
