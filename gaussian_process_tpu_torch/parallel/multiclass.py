"""Class-parallel multi-class Laplace classification over a process mesh
(torch counterpart of ``parallel/multiclass.py``).

Each rank takes a slice of the classes and runs the corrected Alg. 3.3
Newton step (``gp/multiclass.py``) on it, with its per-class factors as one
batched ``torch.linalg`` call. The only couplings across classes are

    - the softmax normaliser over classes        -> all-reduce max + sum
    - W u = pi u - pi sum_c pi_c u_c             -> one all-reduce
    - sum_c E_c (for M = chol(sum_c E_c))        -> one all-reduce of (n, n)
    - R^T c = sum_c c_c                          -> one all-reduce

so a Newton iteration costs the same collectives whatever C. K (n x n) is
built whole on every rank (the tile gram, K1, on the card), as the JAX
package replicates it. Class counts that the axis does not divide are
padded with masked dummy classes: a dummy class has y = 0 and is left out
of the softmax, so pi = sqrt(W) = V = 0 there and it adds nothing to any
sum; the padded fixed point equals the unpadded one.

The Newton loop is a Python loop whose stop test reads all-reduced norms
on the host, equal on every rank, so the ranks take the same branches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.gp import multiclass as _mc
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.parallel import mesh as _mesh


def _local_newton(K, y_loc, valid_loc, *, grp, tol, max_iters):
    """One rank's Newton: classes ``y_loc`` (Cl, n) of the global (Cp, n),
    ``valid_loc`` (Cl,) false at dummy classes, K (n, n) the same on every
    rank (the reference gives every class the same RBF block
    [ref: GP_multi_classification.py:232-238]). Returns (f, pi, lml, iters,
    converged, error_trace): f and pi the rank's class rows, the rest
    equal on every rank."""
    Cl, n = y_loc.shape
    dt = K.dtype
    eye = torch.eye(n, dtype=dt, device=K.device)
    validb = valid_loc[:, None]
    zero = torch.zeros((), dtype=dt, device=K.device)

    def softmax_parts(f_loc):
        # the column-wise softmax over the class axis, sharded over the ranks
        fm = torch.where(validb, f_loc, torch.full((), -1e30, dtype=dt, device=K.device))
        m = _mesh.all_reduce(torch.max(fm, dim=0).values, grp,
                              op=dist.ReduceOp.MAX)  # (n,)
        e = torch.where(validb, torch.exp(f_loc - m[None, :]), zero)
        s = _mesh.all_reduce(torch.sum(e, dim=0), grp)  # (n,)
        return e / s[None, :], m, s

    def w_apply(pi_loc, u_loc):
        # (D - PI PI^T) u: the class sum crosses the ranks
        su = _mesh.all_reduce(torch.sum(pi_loc * u_loc, dim=0), grp)
        return pi_loc * u_loc - pi_loc * su[None, :]

    def Kmul(u_loc):
        return u_loc @ K.T  # K u_c for every class

    def step(f_loc):
        pi, _, _ = softmax_parts(f_loc)
        sw = torch.sqrt(pi)
        B = sw[:, :, None] * K * sw[:, None, :]
        B.diagonal(dim1=-2, dim2=-1).add_(1.0)
        Ls = torch.linalg.cholesky_ex(B).L  # (Cl, n, n)
        # V_c = L_c^{-1} sW_c, so that E_c = sW_c B_c^{-1} sW_c = V_c^T V_c
        Vs = _chol.tri_solve(Ls, eye.expand(Cl, n, n)) * sw[:, None, :]
        e_apply = lambda u: _mc._bmv(Vs.mT, _mc._bmv(Vs, u))  # noqa: E731

        b = w_apply(pi, f_loc) + y_loc - pi  # b = W f + grad  [Alg 3.3 line 7]
        c_vec = e_apply(Kmul(b))
        Vflat = Vs.reshape(Cl * n, n)
        M = torch.linalg.cholesky_ex(_mesh.all_reduce(Vflat.T @ Vflat, grp)).L
        rc = _mesh.all_reduce(torch.sum(c_vec, dim=0), grp)
        m_sol = _chol.cholesky_solve(M, rc)
        a = b - c_vec + e_apply(m_sol.expand(Cl, n))
        return Kmul(a), a, Ls, pi, M

    def global_sums(*terms):
        return _mesh.all_reduce(torch.stack(terms), grp)

    trace = torch.full((max_iters,), float("nan"), dtype=dt, device=K.device)
    f = torch.zeros_like(y_loc)
    iters, err = 0, math.inf
    # float(nan) > tol is False: a NaN error stops the loop
    while iters < max_iters and err > tol:
        f_new = step(f)[0]
        sums = global_sums(torch.sum((f_new - f) ** 2), torch.sum(f_new ** 2))
        e = torch.sqrt(sums[0]) / (1.0 + torch.sqrt(sums[1]))
        trace[iters] = e
        err = float(e)
        f = f_new
        iters += 1

    _, a, Ls, pi, M = step(f)
    _, m, s = softmax_parts(f)
    # The stacked logdet is sum_c log|B_c| + log|sum_c E_c|. A dummy class's
    # factor is chol(I), so its log-diagonal adds 0. The softmax terms and M
    # are the same on every rank already: reducing them again would count
    # them once a rank.
    af, yf, logdet_b = global_sums(torch.sum(a * f), torch.sum(y_loc * f),
                                   torch.sum(torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1))))
    lml = (-0.5 * af + yf - torch.sum(m + torch.log(s)) - logdet_b
           - torch.sum(torch.log(torch.diagonal(M))))
    return f, pi, lml, iters, err <= tol, trace


def make_sharded_multiclass_fit(
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    tol: Optional[float] = None,
    max_iters: int = 100,
    dtype: torch.dtype = torch.float32,
):
    """Build ``(K, y_pad, valid) -> MulticlassLaplaceState`` with the class
    axis of ``y_pad`` (Cp, n) sharded over ``axis`` (Cp a multiple of its
    size; ``valid`` (Cp,) false at padded classes). Every rank passes the
    global K, ``y_pad`` and ``valid``; ``f_mode`` and ``pi`` come back as
    the rank's class rows, the rest equal on every rank. ``tol`` defaults
    to 10 sqrt(eps of ``dtype``)."""
    if tol is None:
        tol = 10.0 * math.sqrt(torch.finfo(dtype).eps)

    @torch.no_grad()
    def fit(K, y_pad, valid):
        K = _mesh.to_mesh(mesh, K)
        y_loc = _mesh.local_rows(mesh, _mesh.to_mesh(mesh, y_pad).to(K.dtype), axis)
        valid_loc = _mesh.local_rows(mesh, _mesh.to_mesh(mesh, valid), axis)
        f, pi, lml, iters, conv, trace = _local_newton(
            K, y_loc, valid_loc, grp=mesh.get_group(axis), tol=tol, max_iters=max_iters)
        return _mc.MulticlassLaplaceState(f_mode=f, pi=pi, lml=lml, iters=iters,
                                          converged=conv, error_trace=trace)

    return fit


def fit_multiclass_sharded(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: torch.Tensor,
    y_labels: torch.Tensor,
    num_classes: int,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    tol: Optional[float] = None,
    max_iters: int = 100,
    dist_method: str = "dot",
) -> _mc.MulticlassLaplaceState:
    """Class-parallel Laplace fit: the result of ``gp.fit_multiclass`` with
    the per-class factorizations spread over ``mesh[axis]``. Every rank
    passes the global inputs and gets the whole state, (C, n) ``f_mode``
    and ``pi`` gathered from the ranks with the padded classes stripped."""
    params = _mesh.params_to_mesh(mesh, params)
    x = _k._dist._as_2d(_mesh.to_mesh(mesh, x_train))
    K = _kops.gram(kernel, params, x, method=dist_method)
    y = _mc.one_hot_targets(_mesh.to_mesh(mesh, y_labels), num_classes, dtype=K.dtype)
    p = _mesh.axis_size(mesh, axis)
    Cp = -(-num_classes // p) * p
    n = y.shape[1]
    y_pad = torch.zeros((Cp, n), dtype=K.dtype, device=K.device)
    y_pad[:num_classes] = y
    valid = torch.arange(Cp, device=K.device) < num_classes

    fit = make_sharded_multiclass_fit(mesh=mesh, axis=axis, tol=tol, max_iters=max_iters,
                                      dtype=K.dtype)
    state = fit(K, y_pad, valid)
    grp = mesh.get_group(axis)
    return state._replace(f_mode=_mesh.all_gather_rows(state.f_mode, grp)[:num_classes],
                          pi=_mesh.all_gather_rows(state.pi, grp)[:num_classes])
