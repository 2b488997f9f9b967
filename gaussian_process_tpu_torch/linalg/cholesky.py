"""Cholesky factorization and triangular solves with jitter escalation
(torch counterpart of ``linalg/cholesky.py``).

``torch.linalg.cholesky_ex`` reports an indefinite input through ``info``
instead of raising, which is the retry signal: the happy path costs one
factorization and one host read of ``info``; retries add jitter on the
schedule ``min_retry * scale * growth**attempt`` that the JAX package uses.

Autograd flows through the accepted ``cholesky_ex`` call only, so the
selected jitter is held constant in the gradient: the semantics of the JAX
package's custom VJP, with no ``autograd.Function`` needed.

Factorization and triangular solves here go to ``torch.linalg``, and so do
those of ``gp/``. The JAX package's blocked factorization, with its panel
kernel, is ported as its own entry point (``linalg/blocked.py``); nothing
here routes through it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CholeskyResult(NamedTuple):
    factor: torch.Tensor  # lower-triangular L with K + jitter*I = L L^T
    jitter: torch.Tensor  # scalar jitter actually applied (0 if none needed)
    ok: torch.Tensor  # scalar bool: factorization succeeded


def solve_dtype(dtype: torch.dtype) -> torch.dtype:
    """Working precision of the dense factorizations that float32 inputs
    feed (the exact posterior, the Nyström preconditioner): float64.

    Measured on the H100 (PERF.md): an fp32 Cholesky at n = 8192 and noise
    5e-4 misses the repo's LML gate (rel 4.0e-4 > 3e-4) because the small
    pivots come out of O(1) Schur-complement differences, and an fp32
    Nyström-Woodbury apply at n = 102400 (lambda_max / s ~ 1e5) makes CG
    diverge. The card runs FP64 GEMMs on its tensor cores at the fp32 SIMT
    rate, so the float64 factorization costs little.
    """
    return torch.float64 if dtype == torch.float32 else dtype


def _chol_ok(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(info == 0) & torch.all(torch.isfinite(d) & (d > 0))


def safe_cholesky(
    K: torch.Tensor,
    *,
    initial_jitter: float = 0.0,
    min_retry_jitter: Optional[float] = None,
    jitter_growth: float = 10.0,
    max_attempts: int = 8,
) -> CholeskyResult:
    """Cholesky of K (+ escalating jitter*I on failure).

    ``initial_jitter`` is added unconditionally (the observation-noise term
    s*I); retries start near machine epsilon for K's dtype, scaled by the
    mean diagonal magnitude. If every attempt fails the factor is NaN and
    ``ok`` is False, as in the JAX package.
    """
    n = K.shape[-1]
    if min_retry_jitter is None:
        min_retry_jitter = 10.0 * torch.finfo(K.dtype).eps
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    K0 = K + initial_jitter * eye
    L, info = torch.linalg.cholesky_ex(K0)
    ok = _chol_ok(L, info)
    jitter = torch.zeros((), dtype=K.dtype, device=K.device)
    if not bool(ok):
        with torch.no_grad():
            diag = torch.diagonal(K0, dim1=-2, dim2=-1)
            scale = torch.mean(torch.abs(diag)) + 1.0
        growth = torch.tensor(jitter_growth, dtype=K.dtype, device=K.device)
        for attempt in range(max_attempts):
            jitter = min_retry_jitter * scale * growth**attempt
            L, info = torch.linalg.cholesky_ex(K0 + jitter * eye)
            ok = _chol_ok(L, info)
            if bool(ok):
                break
        else:
            L = torch.full_like(L, float("nan"))
    return CholeskyResult(factor=L, jitter=jitter + initial_jitter, ok=ok)


def tri_solve(
    L: torch.Tensor, b: torch.Tensor, *, lower: bool = True, trans: bool = False
) -> torch.Tensor:
    """Solve L x = b (or L^T x = b with ``trans``) for triangular L."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    A, upper = (L.mT, lower) if trans else (L, not lower)
    x = torch.linalg.solve_triangular(A, b, upper=upper, left=True)
    return x[..., 0] if vec else x


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b: alpha = L^T \\ (L \\ y) of R&W Alg. 2.1."""
    return tri_solve(L, tri_solve(L, b), trans=True)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log |K| = 2 * sum(log diag L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def add_diagonal(K: torch.Tensor, value) -> torch.Tensor:
    """K + value * I without materialising an identity matrix."""
    out = K.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(value)
    return out
