"""Distributed binary Laplace GP classification over a process mesh (torch
counterpart of ``parallel/classification.py``).

Every rank runs the whole true-Newton iteration (R&W Alg. 3.1, matrix-free
like ``gp.laplace_fit_cg``) on its row block:

- x, y and the latent iterate f stay row-sharded over the ``data`` axis;
  W, the gradient and the link algebra are local;
- every B = I + sW K sW matvec is the ring of ``kernel_blocks.ring_apply``
  (on the card one CUDA full sweep, K2, per ring step, ``x2`` always given)
  wrapped in local sW scalings;
- the preconditioner re-weights the sharded Nyström factor each Newton
  step: V = sW U_local (local), G = I + sum over the ranks of V^T V (one
  all-reduce), chol(G) on every rank alike; each Woodbury apply costs one
  all-reduce of (r, k), as in the regression path;
- the prediction (Alg. 3.2) reduces the mean K_s^T grad with one
  all-reduce and solves the latent variance by one block-CG solve over all
  m test columns, whose right-hand side sW K_s is row-sharded.

V, G and the Woodbury solve live in the Nyström factor's dtype (float64
for fp32 inputs, as the single-card ``gp.classification.woodbury_apply``);
every other tensor, and every result, in the input's. Padded rows (any n)
get W = grad = 0, so B acts as the identity there and they never enter the
Krylov space. The loops' stop tests read all-reduced values on the host,
which every rank holds with equal bits, so the ranks take the same
branches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.gp import classification as _cls
from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.parallel import mesh as _mesh
from gaussian_process_tpu_torch.parallel.cg import (
    _auto_block,
    _landmark_factor,
    _Local,
    _local,
    _matvec,
    _nystrom_apply,
    _pdot,
    _woodbury_factor,
    _zero_invalid,
)


def _ring_operator(kernel, loc: _Local, *, cg_tol, dist_method, block_fn, n_true,
                   precond_rank):
    """(Kmv, U_local): the rank's rows of (K + white I) V by the ring for a
    block V, the padding zeroed, and its rows of the Nyström factor of the
    white-free K on the landmarks strided over the unpadded rows."""
    k_nw, p_nw, white_var = _k.split_white(kernel, loc.params)
    block = block_fn or _auto_block(k_nw, p_nw, dist_method, cg_tol, loc.x_local)
    Kmv = _matvec(loc, block, white_var if white_var is not None else 0.0)
    return Kmv, _landmark_factor(loc, k_nw, p_nw, precond_rank, n_true)


def _woodbury(U_local, sw, grp):
    """v -> (I + V V^T)^{-1} v with V = sW U_local row-sharded: the
    Nyström apply of V at shift 1, built and applied in U's dtype."""
    V = sw.to(U_local.dtype)[:, None] * U_local
    return _nystrom_apply(V, _woodbury_factor(V, 1.0, grp), 1.0, grp)


def _link(f, t, valid):
    """(grad, w) of the logistic likelihood at f, zero at padded rows."""
    pi = torch.sigmoid(f)
    return _zero_invalid(t - pi, valid), _zero_invalid(pi * (1.0 - pi), valid)


def make_laplace_fit(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    tol: Optional[float] = None,
    max_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
):
    """Build the distributed Newton fit ``(params, x, y) -> (f_mode,
    grad_at_mode, sqrt_w, iters, inner_iters, converged)``. ``x`` and ``y``
    are global, with a length the axis divides (pad them and pass
    ``n_true``); ``y`` in {-1, +1}. The three tensors come back as the
    rank's row blocks, ``iters`` and ``inner_iters`` (CG iterations over
    all Newton steps) as ints and ``converged`` as a bool, equal on every
    rank.

    ``tol`` defaults to max(10 sqrt(eps of float32), ``cg_tol``) whatever
    the dtype, as in the JAX package."""
    if tol is None:
        tol = max(10.0 * math.sqrt(torch.finfo(torch.float32).eps), float(cg_tol))

    @torch.no_grad()
    def fit(params, x, y):
        loc = _local(mesh, axis, params, x, y, None, n_true)
        Kblock, U_local = _ring_operator(kernel, loc, cg_tol=cg_tol, dist_method=dist_method,
                                         block_fn=block_fn, n_true=n_true,
                                         precond_rank=precond_rank)

        def Kmv(v):  # the Newton iterates are vectors; the ring takes a block
            return Kblock(v[:, None])[:, 0]

        t = (loc.y_local.to(loc.x_local.dtype) + 1.0) / 2.0
        pdot = _pdot(loc.grp)

        def newton_step(f):
            grad, w = _link(f, t, loc.valid)
            sw = torch.sqrt(w)
            b = w * f + grad
            st = _cg.cg_solve(_cls._b_matvec(Kmv, sw), sw * Kmv(b), tol=cg_tol,
                              max_iters=cg_max_iters,
                              precond_apply=_woodbury(U_local, sw, loc.grp), dot=pdot)
            a = b - sw * st.x
            return Kmv(a), st.iters

        f = torch.zeros_like(t)
        iters, inner, err = 0, 0, math.inf
        # float(nan) > tol is False: a NaN error stops the loop, as the JAX
        # while_loop's condition does
        while iters < max_iters and err > tol:
            f_new, cg_iters = newton_step(f)
            sums = _mesh.all_reduce(torch.stack([torch.sum((f_new - f) ** 2),
                                                 torch.sum(f_new ** 2)]), loc.grp)
            err = float(torch.sqrt(sums[0]) / (1.0 + torch.sqrt(sums[1])))
            f = f_new
            iters += 1
            inner += cg_iters
        grad, w = _link(f, t, loc.valid)
        return f, grad, torch.sqrt(w), iters, inner, err <= tol

    return fit


def make_laplace_predict(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
):
    """Build the distributed Alg. 3.2 prediction ``(params, x, grad, sqrt_w,
    x_test) -> (mean, var, prob, prob_averaged, label)``, each (m,) and
    equal on every rank. ``grad`` and ``sqrt_w`` are the rank's blocks as
    :func:`make_laplace_fit` returns them; ``x`` is global and padded as
    for the fit. The cross-grams K(x_local, x_test) are the tile gram (K1)
    on the card."""

    @torch.no_grad()
    def predict(params, x, grad_local, sw_local, x_test):
        loc = _local(mesh, axis, params, x, None, x_test, n_true)
        Kmv, U_local = _ring_operator(kernel, loc, cg_tol=cg_tol, dist_method=dist_method,
                                      block_fn=block_fn, n_true=n_true,
                                      precond_rank=precond_rank)
        k_nw, p_nw, _ = _k.split_white(kernel, loc.params)
        sw = sw_local
        Ks_local = _zero_invalid(
            _kops.gram(k_nw, p_nw, loc.x_local, loc.x_test, method=dist_method), loc.valid)
        mean = _mesh.all_reduce(Ks_local.T @ grad_local, loc.grp)
        rhs = sw[:, None] * Ks_local
        st = _cg.cg_solve(_cls._b_matvec(Kmv, sw), rhs, tol=cg_tol, max_iters=cg_max_iters,
                          precond_apply=_woodbury(U_local, sw, loc.grp), dot=_pdot(loc.grp))
        kss = _k.gram_diag(kernel, loc.params, loc.x_test)
        var = torch.clamp(kss - _mesh.all_reduce(torch.sum(rhs * st.x, dim=0), loc.grp),
                          min=0.0)
        return tuple(_cls._prediction(mean, var))

    return predict


def distributed_fit_predict_binary(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    tol: Optional[float] = None,
    max_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
):
    """One-shot fit and prediction on any n: pads x and y to the axis with
    zeros and masks the padding. Returns ``(prob, prob_averaged, label,
    mean, var, iters, inner_iters, converged)``, all equal on every
    rank."""
    x_p, y_p, n_true = _mesh.pad_inputs(mesh, axis, x, y)
    fit = make_laplace_fit(
        kernel, mesh=mesh, axis=axis, tol=tol, max_iters=max_iters, cg_tol=cg_tol,
        cg_max_iters=cg_max_iters, precond_rank=precond_rank, dist_method=dist_method,
        n_true=n_true)
    _, grad, sw, iters, inner, conv = fit(params, x_p, y_p)
    predict = make_laplace_predict(
        kernel, mesh=mesh, axis=axis, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
        precond_rank=precond_rank, dist_method=dist_method, n_true=n_true)
    mean, var, prob, prob_avg, label = predict(params, x_p, grad, sw, x_test)
    return prob, prob_avg, label, mean, var, iters, inner, conv
