"""The panel Cholesky factor and inverse on the GPU, with its plain version.

Torch counterpart of the JAX package's ``ops/pallas/chol.py``: for one SPD
(b, b) panel, b <= 1024, both L with A = L L^T and W = L^{-1}, so that a
blocked factorization's panel solve becomes a product against W
(``linalg/blocked.py``). :func:`chol_inv_panel` launches the hand-written
CUDA kernel K6 (``csrc/chol_panel.cu``) on a CUDA tensor and runs
:func:`chol_inv_panel_reference` on a CPU tensor; there is no fallback from
one to the other. An indefinite panel gives NaN on L's diagonal in both.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops

MAX_PANEL = 1024  # the JAX kernel's _MAX_PANEL
SUB = 64  # csrc/chol_panel.cu's tile side: a CUDA panel runs padded to a multiple of it


def _check_panel(A: torch.Tensor) -> int:
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(
            f"chol_inv_panel expects one square (b, b) panel, got {tuple(A.shape)}")
    b = A.shape[0]
    if b > MAX_PANEL:
        raise ValueError(f"panel {b} exceeds max {MAX_PANEL}")
    return b


def chol_inv_panel_reference(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (L, W = L^{-1}) of one panel: the right-looking pivot
    recurrence of the JAX ``_chol_inv_unblocked``, one vectorised step per
    pivot, with W's row j by forward substitution,
    W[j, :] = (e_j - L[j, :j] W[:j, :]) / L[j, j]. Reads A's lower triangle;
    no ``torch.linalg`` call, so it checks K6's arithmetic and not a
    library's. A pivot d enters as rsqrt(d), as in the kernels: a
    non-positive one makes L[j, j] = d rsqrt(d) NaN and every later pivot
    with it."""
    b = _check_panel(A)
    a = torch.tril(A)
    L = torch.zeros_like(A)
    W = torch.zeros_like(A)
    eye = torch.eye(b, dtype=A.dtype, device=A.device)
    for j in range(b):
        r = torch.rsqrt(a[j, j])
        col = a[j:, j] * r
        L[j:, j] = col
        W[j, :j + 1] = (eye[j, :j + 1] - L[j, :j] @ W[:j, :j + 1]) * r
        a[j + 1:, j + 1:] -= torch.outer(col[1:], col[1:])
    return L, W


def chol_inv_panel(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor one SPD panel and invert the factor: A = L L^T, W = L^{-1},
    both lower triangular with zeros above the diagonal. ``A``: (b, b),
    b <= 1024. A CPU tensor takes the plain version; a CUDA tensor must be
    contiguous fp32 and takes K6, and anything else raises. A b that is
    not a multiple of 64 runs on buffers padded to one (A extended by the
    identity) and is cut back to (b, b). NaN on L's diagonal for an
    indefinite panel, as ``lax.linalg.cholesky``."""
    if not A.is_cuda:
        return chol_inv_panel_reference(A)
    from gaussian_process_tpu_torch.ops.cuda import _build

    b = _check_panel(A)
    _kops._check_cuda_f32(A=A)
    ld = -(-b // SUB) * SUB
    L = torch.empty((ld, ld), dtype=torch.float32, device=A.device)
    W = torch.empty((ld, ld), dtype=torch.float32, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.gm_chol_inv_panel(A.data_ptr(), L.data_ptr(), W.data_ptr(), b, ld,
                                    _kops._stream(A.device))
    if err != 0:
        raise RuntimeError(f"gm_chol_inv_panel launch failed: cudaError {err}")
    _kops.launch_counts["chol_inv_panel"] += 1
    if ld != b:
        L, W = L[:b, :b].contiguous(), W[:b, :b].contiguous()
    return L, W
