"""Distributed block-panel Cholesky and triangular solves over a process
mesh (torch counterpart of ``parallel/cholesky.py``).

K lives row-sharded over the ``data`` axis (one block-row of m = n/p rows a
rank, the layout of ``kernel_blocks.sharded_gram``) and is factorized in
place, right-looking, one panel of width m a step:

    for k in 0..p-1:
      1. the diagonal block A[k,k] reaches every rank (all-reduce of the
         block, zero on the other ranks)
      2. L_kk = chol(A[k,k]) on every rank alike
      3. L_ik = A[i,k] L_kk^-T on the rank that owns block-row i
      4. all-gather of the factored panel column L[:,k]
      5. A[i,j] -= L_ik L_jk^T for the trailing columns

Forward and backward block substitution follow the same pattern: a small
triangular solve on the owning rank and an all-reduce of m rows a step.
These are the JAX package's collectives one for one, so
``comm_model.ici_comm_model``'s factor and solve bytes hold for both, in
the working dtype below (``comm_model.verify_posterior_model`` checks the
bytes this module issues).

Precision: fp32 inputs are factored and solved in
``linalg.cholesky.solve_dtype`` (float64), as the single-card exact path
does, because an fp32 factor at n = 8192 misses the repo's LML gate. This
departs from the JAX package, which factors in the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.parallel import mesh as _mesh
from gaussian_process_tpu_torch.parallel.kernel_blocks import _local_block_row


def _nan_unless(ok: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``L`` where the factorization succeeded, else NaN, as
    ``lax.linalg.cholesky`` reports failure (no host sync)."""
    return torch.where(ok, L, torch.full((), float("nan"), dtype=L.dtype, device=L.device))


def _chol_panels_local(A_local: torch.Tensor, grp) -> torch.Tensor:
    """Row-sharded A (m, n) -> row-sharded lower factor L (m, n)."""
    m, n = A_local.shape
    p = dist.get_world_size(grp)
    me = dist.get_rank(grp)
    A = A_local.clone()
    for k in range(p):
        c0, c1 = k * m, (k + 1) * m
        my_blk = A[:, c0:c1]  # block (me, k)
        diag = _mesh.all_reduce(my_blk.clone() if me == k else torch.zeros_like(my_blk), grp)
        Lkk, info = torch.linalg.cholesky_ex(diag)
        Lkk = _nan_unless(info == 0, Lkk)
        if me == k:
            Lblk = Lkk
        elif me > k:
            # X L_kk^T = A[me, k]
            Lblk = torch.linalg.solve_triangular(Lkk.mT, my_blk, upper=True, left=False)
        else:
            Lblk = torch.zeros_like(my_blk)
        A[:, c0:c1] = Lblk
        panel = _mesh.all_gather_rows(Lblk, grp)  # (n, m) column panel
        if me > k and c1 < n:
            # rank-m trailing update (on rank k it would land only above the
            # diagonal, which is zeroed below)
            A[:, c1:] -= Lblk @ panel[c1:].T
    # the strictly-upper blocks of each block-row were never factored; zero
    # them
    rows = me * m + torch.arange(m, device=A.device)[:, None]
    cols = torch.arange(n, device=A.device)[None, :]
    return torch.where(cols <= rows, A, torch.zeros((), dtype=A.dtype, device=A.device))


def _forward_solve_local(L_local: torch.Tensor, b_local: torch.Tensor, grp) -> torch.Tensor:
    """Solve L z = b by block forward substitution; L (m, n) and b (m, t)
    row-sharded, z row-sharded (m, t). One (m, t) all-reduce a step."""
    m, _ = L_local.shape
    p = dist.get_world_size(grp)
    me = dist.get_rank(grp)
    z_local = torch.zeros_like(b_local)
    s = torch.zeros_like(b_local)  # sum_{j<k} L[me, j] z_j
    for k in range(p):
        blk = L_local[:, k * m:(k + 1) * m]  # L[me, k]
        if me == k:
            zk = torch.linalg.solve_triangular(blk, b_local - s, upper=False)
        else:
            zk = torch.zeros_like(b_local)
        zk = _mesh.all_reduce(zk, grp)
        if me > k:
            s = s + blk @ zk
        if me == k:
            z_local = zk
    return z_local


def _backward_solve_local(L_local: torch.Tensor, z_local: torch.Tensor, grp) -> torch.Tensor:
    """Solve L^T x = z by block backward substitution; x row-sharded
    (m, t). Two all-reduces a step: the off-diagonal terms
    sum_{j>k} L[j,k]^T x_j, then the solved block."""
    m, _ = L_local.shape
    p = dist.get_world_size(grp)
    me = dist.get_rank(grp)
    x_local = torch.zeros_like(z_local)
    for i in range(p):
        k = p - 1 - i
        blk = L_local[:, k * m:(k + 1) * m]  # L[me, k]
        contrib = blk.mT @ x_local if me > k else torch.zeros_like(z_local)
        s = _mesh.all_reduce(contrib, grp)
        if me == k:
            xk = torch.linalg.solve_triangular(blk.mT, z_local - s, upper=True)
        else:
            xk = torch.zeros_like(z_local)
        xk = _mesh.all_reduce(xk, grp)
        if me == k:
            x_local = xk
    return x_local


def _rank_block(mesh, axis, t, n):
    """The rank's rows of ``t``: ``t`` itself where it holds m = n/p rows
    (a block as the distributed functions return it), its rows where it
    is global (n rows). At one rank the two coincide."""
    t = _mesh.to_mesh(mesh, t)
    if t.shape[0] == n:
        return _mesh.local_rows(mesh, t, axis)
    if t.shape[0] * _mesh.axis_size(mesh, axis) != n:
        raise ValueError(f"{t.shape[0]} rows are neither the global {n} nor a rank's block")
    return t


def distributed_cholesky(K: torch.Tensor, *, mesh: DeviceMesh, axis: str = "data"
                         ) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric PSD matrix, row-sharded over
    ``axis``. ``K`` is the global (n, n) matrix or this rank's (n/p, n)
    block-row (``kernel_blocks.sharded_gram``); the rank's block-row of L
    comes back. The caller owns conditioning (noise or jitter on the
    diagonal); a failed panel gives NaN, as in the JAX package."""
    n = K.shape[1]
    A = _rank_block(mesh, axis, K, n)
    return _chol_panels_local(A, mesh.get_group(axis))


def distributed_cholesky_solve(L: torch.Tensor, b: torch.Tensor, *, mesh: DeviceMesh,
                               axis: str = "data") -> torch.Tensor:
    """Solve (L L^T) x = b: the distributed alpha = L^T \\ (L \\ y) of
    Alg. 2.1. ``L`` is this rank's block-row (``distributed_cholesky``),
    ``b`` global (n,) / (n, t) or the rank's rows; x comes back as the
    rank's rows."""
    grp = mesh.get_group(axis)
    L = _mesh.to_mesh(mesh, L)
    b = _rank_block(mesh, axis, b, L.shape[1])
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    x = _backward_solve_local(L, _forward_solve_local(L, bb, grp), grp)
    return x[:, 0] if vec else x


def make_distributed_posterior(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    dist_method: str = "dot",
    n_true: Optional[int] = None,
):
    """Build the distributed exact posterior (R&W Alg. 2.1): ``(params, x,
    y, x_test) -> (mean, var, lml, alpha_local)`` with ``x``, ``y`` global
    (a length the axis divides); mean, var and lml come back equal on every
    rank, alpha as the rank's rows, in the input dtype. Block-rows of K by
    the tile gram, the panel factor, the block solves, the predictive mean
    and variance and the LML.

    ``n_true``: where the inputs were padded, padded rows and columns of K
    are masked to an identity block and padded y entries to zero, which
    makes the padding exactly inert. There is no jitter escalation:
    ``noise_variance`` is the conditioner, as in the JAX package."""

    @torch.no_grad()
    def solver(params, x, y, x_test):
        params = _mesh.params_to_mesh(mesh, params)
        grp = mesh.get_group(axis)
        me = mesh.get_local_rank(axis)
        x = _k._dist._as_2d(_mesh.to_mesh(mesh, x))
        x_test = _k._dist._as_2d(_mesh.to_mesh(mesh, x_test))
        x_local = _mesh.local_rows(mesh, x, axis)
        dtype = x.dtype
        work = _chol.solve_dtype(dtype)
        y_local = _mesh.local_rows(mesh, _mesh.to_mesh(mesh, y), axis).to(work)
        m = x_local.shape[0]
        n_pad = x.shape[0]
        k_nw, p_nw, white_var = _k.split_white(kernel, params)
        shift = noise_variance + (white_var if white_var is not None else 0.0)

        x_full = _mesh.all_gather_rows(x_local, grp)
        A_local = _local_block_row(k_nw, p_nw, x_local, x_full, me * m, None,
                                   dist_method).to(work)
        A_local.diagonal(offset=me * m).add_(shift)
        rows = me * m + torch.arange(m, device=x.device)
        masked = n_true is not None and n_true != n_pad
        if masked:
            cols = torch.arange(n_pad, device=x.device)
            valid = (rows[:, None] < n_true) & (cols[None, :] < n_true)
            eye = (rows[:, None] == cols[None, :]).to(work)
            A_local = torch.where(valid, A_local, eye)
            y_local = torch.where(rows < n_true, y_local, torch.zeros((), dtype=work,
                                                                       device=x.device))
        L_local = _chol_panels_local(A_local, grp)

        z = _forward_solve_local(L_local, y_local[:, None], grp)
        alpha_local = _backward_solve_local(L_local, z, grp)[:, 0]

        # mu* = K_s^T alpha, reduced over the shards
        B_local = _kops.gram(k_nw, p_nw, x_local, x_test, method=dist_method).to(work)
        if masked:
            B_local = torch.where((rows < n_true)[:, None], B_local,
                                  torch.zeros((), dtype=work, device=x.device))
        mean = _mesh.all_reduce(B_local.T @ alpha_local, grp)
        # v = L \ K_s stays row-sharded; its column norms reduce once
        v_local = _forward_solve_local(L_local, B_local, grp)
        kss = _k.gram_diag(kernel, params, x_test).to(work)
        var = torch.clamp(kss - _mesh.all_reduce(torch.sum(v_local * v_local, dim=0), grp),
                          min=0.0)

        # LML: -1/2 y^T alpha - sum log diag L - n/2 log 2 pi (padded
        # diagonal entries are 1, padded y and alpha 0)
        diag_blk = L_local[:, me * m:(me + 1) * m]
        logdet_half = _mesh.all_reduce(torch.sum(torch.log(torch.diagonal(diag_blk))), grp)
        yta = _mesh.all_reduce(torch.dot(y_local, alpha_local), grp)
        n = n_pad if n_true is None else n_true
        lml = -0.5 * yta - logdet_half - 0.5 * n * math.log(2.0 * math.pi)
        return mean.to(dtype), var.to(dtype), lml.to(dtype), alpha_local.to(dtype)

    return solver


def distributed_posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    dist_method: str = "dot",
):
    """One-shot :func:`make_distributed_posterior` on any n: the inputs are
    padded to a multiple of the axis and the padding masked, so the result
    matches the unpadded single-card posterior. Returns (mean, var, lml,
    alpha_local)."""
    x_p, y_p, n_true = _mesh.pad_inputs(mesh, axis, x, y)
    solver = make_distributed_posterior(
        kernel, mesh=mesh, axis=axis, noise_variance=noise_variance, dist_method=dist_method,
        n_true=n_true)
    return solver(params, x_p, y_p, x_test)
