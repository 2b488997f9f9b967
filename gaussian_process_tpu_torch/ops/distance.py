"""Pairwise-distance primitives (torch counterpart of ``ops/distance.py``).

The squared distance uses the expansion ||a||^2 + ||b||^2 - 2 a.b after
shifting both sets by the mean of ``a``: sqdist is shift-invariant, but the
expansion's cancellation error scales with ||x||^2, so uncentred
year-valued inputs (x ~ 2000) would lose ~eps * 4e6 absolute accuracy in
float32. Centring makes the error scale with the data's spread instead.
"""

from __future__ import annotations

import torch


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    """Promote (n,) -> (n, 1) so 1-D inputs work like (n, 1)."""
    x = torch.as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    return x


def sqdist(a: torch.Tensor, b: torch.Tensor, *, method: str = "dot") -> torch.Tensor:
    """Pairwise squared Euclidean distance matrix, shape (n, m).

    method="dot": centred ||a||^2 + ||b||^2 - 2ab^T (clamped at 0).
    method="diff": broadcast subtraction (O(n*m*d) memory).
    """
    a = _as_2d(a)
    b = _as_2d(b)
    if method == "diff":
        d = a[:, None, :] - b[None, :, :]
        return torch.sum(d * d, dim=-1)
    center = torch.mean(a, dim=0, keepdim=True).detach()
    a = a - center
    b = b - center
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    # the port leaves matmul TF32 off, so this product is full fp32/fp64
    cross = a @ b.T
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def absdist(a: torch.Tensor, b: torch.Tensor, *, method: str = "dot") -> torch.Tensor:
    """Pairwise Euclidean (l2) distance matrix, shape (n, m)."""
    if method == "diff":
        a = _as_2d(a)
        b = _as_2d(b)
        if a.shape[-1] == 1:
            return torch.abs(a - b.T)
    return torch.sqrt(sqdist(a, b, method=method))
