"""Matrix-free preconditioned conjugate gradients (torch counterpart of the
forward half of ``linalg/cg.py``).

The JAX ``lax.while_loop`` becomes a Python loop. Its stop test reads the
residual norm on the host, one device sync per iteration: at n ~ 1e5 a
kernel matvec takes tens of milliseconds, so the sync costs little.
Capturing the loop in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    z: torch.Tensor
    rz: torch.Tensor
    iters: int
    resnorm: torch.Tensor


def _colsum_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=0)


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    tol: float = 1e-6,
    max_iters: int = 1000,
    precond_diag: Optional[torch.Tensor] = None,
    precond_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    dot: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    init_state: Optional[CGState] = None,
    max_new_iters: Optional[int] = None,
) -> CGState:
    """Solve A x = b for SPD A given only ``matvec`` (x -> A x).

    ``precond_diag``: diag(A) for Jacobi preconditioning (None to skip).
    ``precond_apply``: full preconditioner application r -> M^{-1} r (for
    example :meth:`nystrom.NystromPreconditioner.apply`); overrides
    ``precond_diag``. ``dot``: column-wise inner product.
    Works on single vectors or (n, k) blocks of right-hand sides; all
    columns iterate until the worst column converges.

    ``init_state``: resume exactly from a previous :class:`CGState` (search
    direction, preconditioned residual and rz carry over). ``max_new_iters``
    caps the additional iterations of this call (``iters`` counts the total).
    """
    if dot is None:
        dot = _colsum_dot

    if precond_apply is not None:
        apply_M = precond_apply
    elif precond_diag is not None:
        inv_diag = 1.0 / precond_diag
        if b.ndim > 1:
            inv_diag = inv_diag[:, None]
        apply_M = lambda r: r * inv_diag
    else:
        apply_M = lambda r: r

    bnorm = float(torch.sqrt(torch.max(dot(b, b))))
    stop = tol * max(bnorm, 1e-30)
    iter_cap = max_iters
    if init_state is not None:
        s = init_state
        if max_new_iters is not None:
            iter_cap = min(iter_cap, s.iters + max_new_iters)
    else:
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - matvec(x) if x0 is not None else b
        z = apply_M(r)
        s = CGState(
            x=x,
            r=r,
            p=z,
            z=z,
            rz=dot(r, z),
            iters=0,
            resnorm=torch.sqrt(torch.max(dot(r, r))),
        )
        if max_new_iters is not None:
            iter_cap = min(iter_cap, max_new_iters)

    # float(nan) > stop is False, so a NaN residual stops the loop, as the
    # JAX while_loop's condition does
    while s.iters < iter_cap and float(s.resnorm) > stop:
        Ap = matvec(s.p)
        alpha = s.rz / _nonzero(dot(s.p, Ap))
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / _nonzero(s.rz)
        p = z + beta * s.p
        resnorm = torch.sqrt(torch.max(dot(r, r)))
        s = CGState(x, r, p, z, rz_new, s.iters + 1, resnorm)
    return s
