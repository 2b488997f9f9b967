"""Nyström preconditioner for large-n kernel CG solves (torch counterpart
of ``linalg/nystrom.py``).

    K  ~=  U U^T,     U = K_nm L_mm^{-T}   (n x r),   K_mm = L_mm L_mm^T
    P   =  U U^T + s I
    P^{-1} v = (v - U (s I_r + U^T U)^{-1} U^T v) / s

Setup is O(n r^2 + r^3) and O(n r) memory; each application is two
(n x r) products. The preconditioned condition number drops to roughly
(lambda_{r+1}(K) + s) / s.

The factor is built and applied in ``cholesky.solve_dtype`` (float64 for
float32 inputs): the Woodbury apply cancels by up to lambda_max / s, so in
float32 it is too inexact for CG to converge at n ~ 1e5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.utils import profiling as _profiling


class NystromPreconditioner(NamedTuple):
    U: torch.Tensor  # (n, r) Nyström factor K_nm L_mm^{-T}, in the working dtype
    chol_G: torch.Tensor  # (r, r) chol(s I + U^T U)
    shift: torch.Tensor  # scalar s
    landmarks: torch.Tensor  # (r,) landmark indices into x

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """P^{-1} v via Woodbury; v is (n,) or (n, k). Computed in the
        factor's dtype and returned in v's."""
        with _profiling.span("gp.solvers.nystrom_apply"):
            vec = v.ndim == 1
            vv = (v[:, None] if vec else v).to(self.U.dtype)
            z = _chol.cholesky_solve(self.chol_G, self.U.T @ vv)
            out = ((vv - self.U @ z) / self.shift).to(v.dtype)
            return out[:, 0] if vec else out


def make_nystrom_preconditioner(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    *,
    shift,
    rank: int = 512,
    generator: Optional[torch.Generator] = None,
    jitter: float = 1e-6,
    row_chunk: Optional[int] = None,
) -> NystromPreconditioner:
    """Build the rank-``rank`` Nyström preconditioner for K(x, x) + shift I.

    ``kernel``/``params`` must be the white-free kernel (the caller folds
    White's variance into ``shift``). Landmarks are an evenly strided
    subset (``generator=None``, deterministic) or a uniform random subset
    drawn with ``generator``. ``row_chunk``: see :func:`make_nystrom_factor`.
    """
    with _profiling.span("gp.solvers.nystrom_build"):
        U, G, idx = make_nystrom_factor(
            kernel, params, x, rank=rank, generator=generator, jitter=jitter,
            row_chunk=row_chunk,
        )
        shift = torch.as_tensor(shift, dtype=U.dtype, device=U.device)
        G = G + shift * torch.eye(G.shape[0], dtype=U.dtype, device=U.device)
        chol_G = _chol.safe_cholesky(G).factor
        return NystromPreconditioner(U=U, chol_G=chol_G, shift=shift, landmarks=idx)


def make_nystrom_factor(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    *,
    rank: int = 512,
    generator: Optional[torch.Generator] = None,
    jitter: float = 1e-6,
    row_chunk: Optional[int] = None,
):
    """The bare rank-``rank`` Nyström factor of K(x, x): returns
    ``(U, G, landmarks)`` with K ~= U U^T and G = U^T U (r, r), in
    ``cholesky.solve_dtype(x.dtype)``.

    ``row_chunk``: build U in row blocks of this size. The dense build
    holds K_nm, its transpose-solve and U at once (about 3 n*r floats);
    the chunked build's workspace is O(row_chunk * rank) beside U, at the
    cost of applying an explicit L_mm^{-T} per block. None: chunk at 65536
    rows when n * r exceeds 2^28 floats, else the dense build.
    """
    x = _k._dist._as_2d(x)
    x = x.to(_chol.solve_dtype(x.dtype))
    n = x.shape[0]
    r = min(rank, n)
    if generator is None:
        idx = torch.arange(r, device=x.device) * (n // r)
    else:
        idx = torch.randperm(n, generator=generator, device=generator.device)[:r]
        idx = idx.to(x.device)
    z = x[idx]

    K_mm = _k.gram(kernel, params, z)
    # relative jitter keeps chol(K_mm) sane when landmarks nearly coincide
    L_mm = _chol.safe_cholesky(K_mm, initial_jitter=jitter).factor

    if row_chunk is None and n * r > (1 << 28):
        row_chunk = 65536
    if row_chunk is not None and n > row_chunk:
        eye = torch.eye(r, dtype=x.dtype, device=x.device)
        Wt = _chol.tri_solve(L_mm, eye).T  # L_mm^{-T} (r, r)
        U = torch.empty((n, r), dtype=x.dtype, device=x.device)
        G = torch.zeros((r, r), dtype=x.dtype, device=x.device)
        for i in range(0, n, row_chunk):
            Uc = _k.gram(kernel, params, x[i : i + row_chunk], z) @ Wt
            U[i : i + row_chunk] = Uc
            G += Uc.T @ Uc
    else:
        K_nm = _k.gram(kernel, params, x, z)  # (n, r)
        # U = K_nm L_mm^{-T}  <=>  U^T = L_mm^{-1} K_nm^T
        Ut = _chol.tri_solve(L_mm, K_nm.T)
        U = Ut.T
        G = Ut @ U
    return U, G, idx
