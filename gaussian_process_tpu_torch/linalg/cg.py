"""Matrix-free preconditioned conjugate gradients (torch counterpart of
``linalg/cg.py``): ``cg_solve`` and the differentiable ``cg_solve_grad``.

The JAX ``lax.while_loop`` becomes a Python loop. Its stop test reads the
residual norm on the host, one device sync per iteration: at n ~ 1e5 a
kernel matvec takes tens of milliseconds, so the sync costs little.
Capturing the loop in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.utils import profiling as _profiling

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
    with _profiling.span("gp.solvers.cg"):
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
        def going(state: CGState) -> bool:
            return state.iters < iter_cap and float(state.resnorm) > stop

        go = going(s)
        while go:
            # one span an iteration, the stop test that ends it (its sync) included
            with _profiling.span("gp.solvers.cg_iteration"):
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
                go = going(s)
        return s


class _CGSolveGrad(torch.autograd.Function):
    """x = A(params)^{-1} b, differentiated by the implicit-function
    theorem (the JAX package's ``cg_solve_grad`` custom VJP)."""

    @staticmethod
    def forward(ctx, matvec_fn, tol, max_iters, structure, b, precond_diag, *leaves):
        params = _k.tree_unflatten(structure, leaves)
        x = cg_solve(lambda v: matvec_fn(params, v), b, tol=tol, max_iters=max_iters,
                     precond_diag=precond_diag).x
        ctx.matvec_fn, ctx.tol, ctx.max_iters, ctx.structure = matvec_fn, tol, max_iters, structure
        ctx.save_for_backward(x, precond_diag, *leaves)
        return x

    @staticmethod
    def backward(ctx, ct):
        x, precond_diag, *leaves = ctx.saved_tensors
        params = _k.tree_unflatten(ctx.structure, leaves)
        # w = A^{-1} x_bar: one more CG solve, which is also dL/db
        w = cg_solve(lambda v: ctx.matvec_fn(params, v), ct, tol=ctx.tol,
                     max_iters=ctx.max_iters, precond_diag=precond_diag).x
        want = ctx.needs_input_grad[6:]
        d_leaves = [None] * len(leaves)
        if any(want):
            # params pullback dL/dp = -<w, (dA/dp) x>: one VJP of the matvec
            with torch.enable_grad():
                grad_leaves = [leaf.detach().requires_grad_(True) if need else leaf
                               for leaf, need in zip(leaves, want)]
                out = ctx.matvec_fn(_k.tree_unflatten(ctx.structure, grad_leaves), x)
                wanted = [leaf for leaf, need in zip(grad_leaves, want) if need]
                grads = iter(torch.autograd.grad(out, wanted, grad_outputs=-w,
                                                 allow_unused=True))
            for i, need in enumerate(want):
                if need:
                    g = next(grads)
                    d_leaves[i] = torch.zeros_like(leaves[i]) if g is None else g
        d_pre = None if precond_diag is None else torch.zeros_like(precond_diag)
        return (None, None, None, None, w, d_pre, *d_leaves)


def cg_solve_grad(
    matvec_fn: Callable,
    tol: float,
    max_iters: int,
    params,
    b: torch.Tensor,
    precond_diag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable matrix-free solve x = A(params)^{-1} b for SPD A.

    ``matvec_fn(params, v)`` applies the full operator (kernel matvec plus
    any noise shift); ``params`` is a tree of tensors whose leaves become
    the Function's inputs. Reverse mode does not unroll the CG loop:

        dL/db      = A^{-1} x_bar            (one more CG solve)
        dL/dparams = -w^T (dA/dparams) x,  w = A^{-1} x_bar

    where the params pullback is one VJP of ``matvec_fn`` at the solved x;
    with ``ops.cuda.gram_matvec`` that VJP is the CUDA backward sweep.
    ``precond_diag`` only changes the convergence speed, so its gradient is
    zero.
    """
    leaves = _k.tree_leaves(params)
    return _CGSolveGrad.apply(matvec_fn, tol, max_iters, params, b, precond_diag, *leaves)
