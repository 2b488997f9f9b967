"""Blocked (panel) Cholesky and triangular solves (torch counterpart of
``linalg/blocked.py``).

The JAX package re-blocks the factorization with a wide panel (default
1024) for the TPU's matrix unit, and can factor and invert each diagonal
panel in one Pallas program (``ops/pallas/chol.py``). The port keeps the
same algorithm and the same public functions, and its panel kernel is the
hand-written CUDA kernel K6 (``ops.cuda.chol_inv_panel``):

- :func:`blocked_cholesky`: left-looking, so every panel gathers its
  updates from the finished factor columns in one product each (exact
  lower-triangle work, growing inner dimensions);
- :func:`blocked_tri_solve`: L X = B as a chain of products against the
  diagonal panels' explicit inverses (:func:`panel_inverses`, shareable
  between a forward and a transposed solve).

The update products and the panel solve against W = L_kk^{-1} are plain
matrix products outside any kernel, so they go to ``torch.matmul``, as the
JAX package leaves them to XLA. ``precision`` is the JAX argument: "highest"
(the default) keeps fp32 products in fp32 with TF32 off; "high" lets the
card take TF32 products (about three decimal digits) and is set and restored
around the call. On the CPU both are exact fp32. The factor is written into
one preallocated tensor in place, panel by panel.

``safe_cholesky`` and ``gp`` do not route through this module: they factor
with ``torch.linalg``, in float64 for fp32 inputs (``linalg/cholesky.py``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from gaussian_process_tpu_torch.linalg import cholesky as _chol

DEFAULT_BLOCK = 1024
# below this size the library factorization is already fine and blocking
# only adds launches
MIN_BLOCKED_N = 4096

_TF32 = {"highest": False, "high": True}


def _use_kernel_panels(dtype: torch.dtype, use_kernel: Optional[bool]) -> bool:
    """The JAX package's ``_use_pallas_panels`` rule: None means the library
    panels; True takes K6 panels (``ops.cuda.chol_inv_panel``) for fp32
    only, and float64 keeps the library panels. The JAX default is off on a
    TPU measurement; ``PERF.md`` has the H100's."""
    if use_kernel is None:
        return False
    return bool(use_kernel) and dtype == torch.float32


@contextlib.contextmanager
def _precision(precision: str):
    """TF32 matmuls on ("high") or off ("highest") for the block, restored
    after it."""
    if precision not in _TF32:
        raise ValueError(f"precision must be 'highest' or 'high', got {precision!r}")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Library Cholesky with ``lax.linalg.cholesky``'s failure semantics: an
    indefinite input gives a factor of NaNs (``cholesky_ex`` leaves a partial
    factor and reports through ``info``, read here on the device without a
    host sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit L^{-1} of a lower-triangular diagonal block: the panel-wide
    triangular solve becomes a product against it (the cuSOLVER potrf
    trick the JAX package uses)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _bounds(n: int, block: int) -> List[Tuple[int, int]]:
    return [(off, min(block, n - off)) for off in range(0, n, block)]


def blocked_cholesky(
    K: torch.Tensor,
    *,
    block: int = DEFAULT_BLOCK,
    precision: str = "highest",
    use_kernel: Optional[bool] = None,
    trsm_via_inverse: bool = False,
) -> torch.Tensor:
    """Lower Cholesky factor of PSD ``K`` by left-looking tiled
    factorization; the JAX ``blocked_cholesky`` with ``use_kernel`` for its
    ``use_pallas``. Each panel k gathers all its updates from the finished
    columns L[:, :kb]:

        A_kk' = K_kk - L_k: L_k:^T          (one small product, inner dim kb)
        L_kk  = chol(A_kk')                 (library, or K6 with W_kk = L_kk^{-1})
        A_col = K_col - L_below L_k:^T      (one product, inner dim kb)
        L_col = A_col L_kk^{-T}             (triangular solve, or A_col W_kk^T)

    ``n <= max(block, MIN_BLOCKED_N)`` delegates to one library call.
    ``use_kernel=True`` factors and inverts each fp32 diagonal panel with
    K6 (the plain version on a CPU tensor), deciding before any launch;
    ``trsm_via_inverse`` turns the library panels' solve into a product
    against the explicit inverse, always at "highest". NaN semantics are
    ``lax.linalg.cholesky``'s: an indefinite panel gives NaN, which the
    update products carry into every later panel's diagonal. The factor is
    written in place, so autograd refuses a backward through the blocked
    branch; differentiate through ``torch.linalg.cholesky`` instead.
    """
    if K.ndim != 2:
        raise ValueError("blocked_cholesky expects a single (n, n) matrix")
    n = K.shape[-1]
    if n <= max(block, MIN_BLOCKED_N):
        return _cholesky(K)
    kernel_panels = _use_kernel_panels(K.dtype, use_kernel)
    if kernel_panels:
        from gaussian_process_tpu_torch.ops.cuda import chol as _kchol

    L = torch.zeros_like(K)
    with _precision(precision):
        for off, b in _bounds(n, block):
            A_kk = K[off:off + b, off:off + b]
            Lrow = L[off:off + b, :off]
            if off > 0:
                A_kk = A_kk - Lrow @ Lrow.T
            if kernel_panels:
                L_kk, W_kk = _kchol.chol_inv_panel(A_kk.contiguous())
            else:
                L_kk = _cholesky(A_kk)
            L[off:off + b, off:off + b] = L_kk
            if off + b == n:
                break
            A_col = K[off + b:, off:off + b]
            if off > 0:
                A_col = A_col - L[off + b:, :off] @ Lrow.T
            if kernel_panels:
                L_col = A_col @ W_kk.T
            elif trsm_via_inverse:
                with _precision("highest"):
                    L_col = A_col @ _tri_inv(L_kk).T
            else:
                L_col = torch.linalg.solve_triangular(L_kk.T, A_col, upper=True, left=False)
            L[off + b:, off:off + b] = L_col
    return L


# the left-looking algorithm is blocked_cholesky; the JAX package keeps the
# alias for callers that name the algorithm
leftlook_cholesky = blocked_cholesky


def panel_inverses(L: torch.Tensor, *, block: int = DEFAULT_BLOCK) -> List[torch.Tensor]:
    """Explicit inverses of L's diagonal panels, for several
    :func:`blocked_tri_solve` calls against one factor (a forward and a
    transposed solve pay the inversions once)."""
    return [_tri_inv(L[o:o + b, o:o + b]) for o, b in _bounds(L.shape[-1], block)]


def blocked_tri_solve(
    L: torch.Tensor,
    B: torch.Tensor,
    *,
    trans: bool = False,
    block: int = DEFAULT_BLOCK,
    precision: str = "highest",
    invs: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Solve L X = B (L^T X = B with ``trans``) for lower-triangular L, as a
    chain of products with a running update of the right-hand side:

        forward, block rows top-down:  X_i = L_ii^{-1} B_i;  B_rest -= L[rest, i] X_i
        ``trans``, bottom-up, with L[i, :]^T.

    ``B``: (n,) or (n, m). ``invs``: :func:`panel_inverses` of L at the same
    ``block``; without it, ``n <= max(block, MIN_BLOCKED_N)`` delegates to
    one library solve. ``precision`` as in :func:`blocked_cholesky`.
    """
    n = L.shape[-1]
    if n <= max(block, MIN_BLOCKED_N) and invs is None:
        return _chol.tri_solve(L, B, trans=trans)
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    bounds = _bounds(n, block)
    if invs is None:
        invs = panel_inverses(L, block=block)
    X_blocks: List[Optional[torch.Tensor]] = [None] * len(bounds)
    Bwork = B
    with _precision(precision):
        if not trans:
            for i, (oi, bi) in enumerate(bounds):
                Xi = invs[i] @ Bwork[:bi]
                X_blocks[i] = Xi
                if oi + bi == n:
                    break
                Bwork = Bwork[bi:] - L[oi + bi:, oi:oi + bi] @ Xi
        else:
            for i in range(len(bounds) - 1, -1, -1):
                oi, bi = bounds[i]
                Xi = invs[i].T @ Bwork[oi:]
                X_blocks[i] = Xi
                if oi == 0:
                    break
                Bwork = Bwork[:oi] - L[oi:oi + bi, :oi].T @ Xi
    X = torch.cat(X_blocks, dim=0)
    return X[:, 0] if vec else X
