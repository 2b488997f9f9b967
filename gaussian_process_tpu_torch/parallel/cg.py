"""Distributed conjugate-gradient GP solves over a process mesh (torch
counterpart of ``parallel/cg.py``).

Every rank runs the whole CG loop on its row block: vectors stay
row-sharded, the matvec is the ring of ``kernel_blocks.ring_apply`` over the
data axis, and inner products reduce with one all-reduce. The loop's stop
test reads the all-reduced residual on the host, which every rank holds with
equal bits, so the ranks take the same branches. On the card each ring step
is one launch of the CUDA full sweep (K2) on the cross-set block
K(x_local, xb) @ vb, and the cross-grams K(x_local, x_test) are the tile
gram (K1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.linalg import cg as _cg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.parallel import mesh as _mesh
from gaussian_process_tpu_torch.parallel.kernel_blocks import ring_apply


def _landmark_global_indices(n_eff: int, rank: int) -> np.ndarray:
    """Evenly strided landmark indices into the first ``n_eff`` global rows
    (the unpadded data): the single-card Nyström's deterministic choice, so
    both build the same subspace."""
    r = min(rank, n_eff)
    return np.arange(r, dtype=np.int64) * (n_eff // r)


def _nystrom_factor_local(k_nw, p_nw, x_local, *, grp, g_idx, valid):
    """This rank's rows of the Nyström factor U = K(x, z) L_mm^{-T}.

    The landmarks z (r, d) are assembled with one all-reduce (each rank
    contributes the landmark rows it owns); chol(K_mm) is computed on every
    rank alike; U stays row-sharded. Built in ``cholesky.solve_dtype``
    (float64 for fp32 inputs), as the single-card factor is. ``valid``
    masks padded rows (or None)."""
    me = dist.get_rank(grp)
    x2 = _k._dist._as_2d(x_local)
    x2 = x2.to(_chol.solve_dtype(x2.dtype))
    m_local = x2.shape[0]
    g = torch.as_tensor(g_idx, device=x2.device)
    own = (g >= me * m_local) & (g < (me + 1) * m_local)
    local_pos = torch.clamp(g - me * m_local, 0, m_local - 1)
    z = torch.where(own[:, None], x2[local_pos], torch.zeros((), dtype=x2.dtype, device=x2.device))
    z = _mesh.all_reduce(z, grp)  # (r, d)

    K_mm = _k.gram(k_nw, p_nw, z)
    L_mm = _chol.safe_cholesky(K_mm, initial_jitter=1e-6).factor
    K_xm = _k.gram(k_nw, p_nw, x2, z)  # (m_local, r)
    if valid is not None:
        K_xm = torch.where(valid[:, None], K_xm, torch.zeros((), dtype=K_xm.dtype,
                                                             device=K_xm.device))
    return _chol.tri_solve(L_mm, K_xm.T).T  # (L_mm^{-1} K_mx)^T


def _woodbury_factor(U_local, shift, grp):
    """chol(G) for the Woodbury solve of U U^T + s I: G = s I + U^T U,
    reduced over the ranks and factored on every rank alike."""
    r = U_local.shape[1]
    G = _mesh.all_reduce(U_local.T @ U_local, grp)
    G = G + shift * torch.eye(r, dtype=U_local.dtype, device=U_local.device)
    return _chol.safe_cholesky(G).factor


def _nystrom_apply(U_local, chol_G, shift, grp):
    """r -> P^{-1} r by Woodbury on row-sharded vectors: one all-reduce of
    (r, k) a call, computed in the factor's dtype and returned in v's."""

    def apply(v):
        vec = v.ndim == 1
        vv = (v[:, None] if vec else v).to(U_local.dtype)
        w = _mesh.all_reduce(U_local.T @ vv, grp)
        zz = _chol.cholesky_solve(chol_G, w)
        out = ((vv - U_local @ zz) / shift).to(v.dtype)
        return out[:, 0] if vec else out

    return apply


def _auto_block(k_nw, p_nw, dist_method, tol, x):
    """The ring step's block product K(x_local, xb) @ vb. For fp32 CUDA
    inputs and a stationary kernel (``kops.use_matvec_kernel``) the CUDA
    full sweep (K2), ``x2`` always given, under the JAX tolerance rule's
    ``dot_mode`` (``gp.regression.cg_dot_mode``); elsewhere the plain gram
    product, as the JAX package falls back to XLA. A kernel that fails to
    build or launch raises."""
    if _kops.use_matvec_kernel(k_nw, x):
        mode = _reg.cg_dot_mode(tol)
        return lambda xl, xb, vb: _kops.gram_matvec(k_nw, p_nw, xl, xb, vb, dot_mode=mode)
    return lambda xl, xb, vb: _kops.gram(k_nw, p_nw, xl, xb, method=dist_method) @ vb


def _zero_invalid(t, valid):
    if valid is None:
        return t
    mask = valid if t.ndim == 1 else valid[:, None]
    return torch.where(mask, t, torch.zeros((), dtype=t.dtype, device=t.device))


class _Local(NamedTuple):
    """One rank's view of a solve: its row blocks and the shard geometry."""

    params: _k.Params
    x_local: torch.Tensor
    y_local: torch.Tensor
    x_test: torch.Tensor
    grp: object
    me: int
    n_pad: int
    valid: Optional[torch.Tensor]  # (m_local,) rows below n_true, or None


def _local(mesh, axis, params, x, y, x_test, n_true) -> _Local:
    """Rank view of global inputs; ``y`` and ``x_test`` may be None."""
    x = _k._dist._as_2d(_mesh.to_mesh(mesh, x))
    x_local = _mesh.local_rows(mesh, x, axis)
    me = mesh.get_local_rank(axis)
    m_local = x_local.shape[0]
    n_pad = x.shape[0]
    valid = None
    if n_true is not None and n_true != n_pad:
        valid = me * m_local + torch.arange(m_local, device=x.device) < n_true
    y_local = None
    if y is not None:
        y_local = _zero_invalid(_mesh.local_rows(mesh, _mesh.to_mesh(mesh, y), axis), valid)
    if x_test is not None:
        x_test = _k._dist._as_2d(_mesh.to_mesh(mesh, x_test))
    return _Local(_mesh.params_to_mesh(mesh, params), x_local, y_local, x_test,
                  mesh.get_group(axis), me, n_pad, valid)


def _pdot(grp):
    return lambda u, v: _mesh.all_reduce(torch.sum(u * v, dim=0), grp)


def _matvec(loc: _Local, block, diag_shift):
    """v_local -> rows of (K + shift I) v, the padding kept out of the
    Krylov space."""

    def matvec(v_local):
        out = ring_apply(block, loc.x_local, v_local, loc.grp) + diag_shift * v_local
        return _zero_invalid(out, loc.valid)

    return matvec


def _landmark_factor(loc: _Local, k_nw, p_nw, precond_rank, n_true):
    """This rank's rows of the Nyström factor U on the landmarks strided
    over the unpadded rows."""
    n_eff = n_true if n_true is not None else loc.n_pad
    return _nystrom_factor_local(k_nw, p_nw, loc.x_local, grp=loc.grp,
                                 g_idx=_landmark_global_indices(n_eff, precond_rank),
                                 valid=loc.valid)


def _nystrom_pre(loc: _Local, k_nw, p_nw, diag_shift, precond_rank, n_true):
    """The sharded Nyström preconditioner P = U U^T + s I: (U_local,
    chol_G)."""
    U_local = _landmark_factor(loc, k_nw, p_nw, precond_rank, n_true)
    return U_local, _woodbury_factor(U_local, diag_shift, loc.grp)


def _precond_kwargs(loc: _Local, k_nw, p_nw, diag_shift, preconditioner, precond_rank, n_true):
    if preconditioner == "nystrom":
        U_local, chol_G = _nystrom_pre(loc, k_nw, p_nw, diag_shift, precond_rank, n_true)
        return {"precond_apply": _nystrom_apply(U_local, chol_G, diag_shift, loc.grp)}
    if preconditioner == "jacobi":
        return {"precond_diag": _k.gram_diag(k_nw, p_nw, loc.x_local) + diag_shift}
    raise ValueError(f"unknown preconditioner {preconditioner!r}")


def _operator(kernel, loc: _Local, *, noise_variance, tol, dist_method, block_fn, n_true,
              preconditioner, precond_rank) -> dict:
    """The solve's operator on this rank: the ring matvec of K + shift I,
    the preconditioner's ``cg_solve`` arguments (none for
    ``preconditioner=None``: a segment takes the prebuilt factor), the
    reduced inner product, and the white-free kernel."""
    k_nw, p_nw, white_var = _k.split_white(kernel, loc.params)
    diag_shift = noise_variance + (white_var if white_var is not None else 0.0)
    block = block_fn or _auto_block(k_nw, p_nw, dist_method, tol, loc.x_local)
    precond = ({} if preconditioner is None else
               _precond_kwargs(loc, k_nw, p_nw, diag_shift, preconditioner, precond_rank,
                               n_true))
    return dict(matvec=_matvec(loc, block, diag_shift), precond_kwargs=precond,
                pdot=_pdot(loc.grp), grp=loc.grp, k_nw=k_nw, p_nw=p_nw)


def make_posterior_mean_cg(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
    preconditioner: str = "jacobi",
    precond_rank: int = 512,
):
    """Build the distributed solver ``(params, x, y, x_test) -> (mean,
    alpha_local, iters, resnorm)``; ``x``, ``y`` are global with a length
    the axis divides, ``mean`` comes back equal on every rank and
    ``alpha_local`` as the rank's rows.

    ``n_true``: where the inputs were padded (``mesh.pad_to_multiple``),
    zero RHS entries and a masked matvec keep the padded coordinates out of
    the Krylov space. ``preconditioner``: "jacobi" or "nystrom" (rank
    ``precond_rank``, built sharded; needed at n ~ 1e5, where Jacobi
    stalls)."""

    @torch.no_grad()
    def solver(params, x, y, x_test):
        loc = _local(mesh, axis, params, x, y, x_test, n_true)
        op = _operator(kernel, loc, noise_variance=noise_variance, tol=tol,
                       dist_method=dist_method, block_fn=block_fn, n_true=n_true,
                       preconditioner=preconditioner, precond_rank=precond_rank)
        state = _cg.cg_solve(op["matvec"], loc.y_local, tol=tol, max_iters=max_iters,
                             dot=op["pdot"], **op["precond_kwargs"])
        # mu* = sum over the shards of K(x_test, x_local) @ alpha_local
        cross = _kops.gram(op["k_nw"], op["p_nw"], loc.x_test, loc.x_local,
                           method=dist_method)
        mean = _mesh.all_reduce(cross @ state.x, loc.grp)
        return mean, state.x, state.iters, state.resnorm

    return solver


def distributed_posterior_mean_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    dist_method: str = "dot",
    block_fn=None,
    preconditioner: str = "jacobi",
    precond_rank: int = 512,
):
    """One-shot :func:`make_posterior_mean_cg` on any n: the inputs are
    padded to a multiple of the axis and the padding is masked. Returns
    (mean, alpha_local, iters, resnorm)."""
    x_p, y_p, n_true = _mesh.pad_inputs(mesh, axis, x, y)
    solver = make_posterior_mean_cg(
        kernel, mesh=mesh, axis=axis, noise_variance=noise_variance, tol=tol,
        max_iters=max_iters, dist_method=dist_method, block_fn=block_fn, n_true=n_true,
        preconditioner=preconditioner, precond_rank=precond_rank)
    return solver(params, x_p, y_p, x_test)


def _block_ctx(kernel, loc: _Local, *, dist_method, **op_kw):
    """What the block-RHS solvers share: :func:`_operator` and the
    [y | K_s] RHS. One definition serves the monolithic solver and every
    segment, so they are the same arithmetic."""
    ctx = _operator(kernel, loc, dist_method=dist_method, **op_kw)
    Ks_local = _zero_invalid(
        _kops.gram(ctx["k_nw"], ctx["p_nw"], loc.x_local, loc.x_test, method=dist_method),
        loc.valid)
    return dict(ctx, Ks_local=Ks_local, rhs=torch.cat([loc.y_local[:, None], Ks_local], dim=1))


def _predict(kernel, loc: _Local, Ks_local, X):
    """mean and variance from the solved block X = [alpha | U]."""
    alpha_local = X[:, 0]
    U = X[:, 1:]
    mean = _mesh.all_reduce(Ks_local.T @ alpha_local, loc.grp)
    kss = _k.gram_diag(kernel, loc.params, loc.x_test)
    var = torch.clamp(kss - _mesh.all_reduce(torch.sum(Ks_local * U, dim=0), loc.grp), min=0.0)
    return mean, var, alpha_local


def make_posterior_cg(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
    preconditioner: str = "jacobi",
    precond_rank: int = 512,
):
    """Distributed matrix-free posterior with mean and variance, the
    counterpart of ``gp.posterior_cg``: one block-CG solve of
    (K + s I) [alpha | U] = [y | K_s] with every test column riding the same
    ring matvec, then one all-reduce each for the mean and the variance.
    Returns ``(params, x, y, x_test) -> (mean, var, alpha_local, iters,
    resnorm)``; see :func:`make_posterior_mean_cg` for the arguments."""
    ctx_kw = dict(noise_variance=noise_variance, tol=tol, dist_method=dist_method,
                  block_fn=block_fn, n_true=n_true, preconditioner=preconditioner,
                  precond_rank=precond_rank)

    @torch.no_grad()
    def solver(params, x, y, x_test):
        loc = _local(mesh, axis, params, x, y, x_test, n_true)
        ctx = _block_ctx(kernel, loc, **ctx_kw)
        state = _cg.cg_solve(ctx["matvec"], ctx["rhs"], tol=tol, max_iters=max_iters,
                             dot=ctx["pdot"], **ctx["precond_kwargs"])
        mean, var, alpha_local = _predict(kernel, loc, ctx["Ks_local"], state.x)
        return mean, var, alpha_local, state.iters, state.resnorm

    return solver


class ShardedCGState(NamedTuple):
    """One rank's shard of a segmented distributed solve's CG state: the
    fields of ``linalg.cg.CGState`` (x, r, p, z are the rank's rows) and the
    problem it belongs to, which a resume checks. Every leaf is a tensor or
    a scalar, so it round-trips through ``utils.checkpoint.save(...,
    per_host=True)`` (one file a rank)."""

    x: torch.Tensor  # (m_local, 1 + t) solution block [alpha | U]
    r: torch.Tensor
    p: torch.Tensor
    z: torch.Tensor
    rz: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    n: int  # training points, unpadded
    mesh_size: int  # ranks on the data axis
    shard: int  # this rank's index on the data axis

    def cg_state(self) -> _cg.CGState:
        return _cg.CGState(*self[:7])


def make_posterior_cg_segments(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    segment_iters: int = 40,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
    preconditioner: str = "nystrom",
    precond_rank: int = 512,
):
    """The segmented distributed posterior's programs, sharing one body
    (:func:`_block_ctx`):

    - ``build_pre(params, x) -> pre``: the sharded Nyström preconditioner
      (U row-sharded, chol_G and the shift on every rank), built once and
      handed to every segment (None under "jacobi", whose diagonal each
      segment recomputes);
    - ``start(params, x, y, x_test, pre) -> (state, bnorm)``: at most
      ``segment_iters`` iterations; ``state`` is a :class:`ShardedCGState`;
    - ``cont(params, x, y, x_test, pre, state) -> state``: resume exactly
      (conjugacy kept, ``cg_solve``'s ``init_state``);
    - ``finish(params, x, y, x_test, state) -> (mean, var, alpha_local,
      iters, resnorm)``;
    - ``bnorm(params, x, y, x_test)``: the largest right-hand-side column
      norm, from which a resumed drive takes its stop test.

    Under "jacobi" ``start`` and ``cont`` ignore ``pre``. (The JAX
    package's jacobi segments hand a scalar ``pre`` against a tuple spec
    and do not run; these do, and equal the monolithic solve.)"""
    if preconditioner not in ("nystrom", "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    nystrom = preconditioner == "nystrom"
    ctx_kw = dict(noise_variance=noise_variance, tol=tol, dist_method=dist_method,
                  block_fn=block_fn, n_true=n_true, precond_rank=precond_rank,
                  preconditioner=None if nystrom else "jacobi")

    def _ctx(params, x, y, x_test):
        loc = _local(mesh, axis, params, x, y, x_test, n_true)
        return loc, _block_ctx(kernel, loc, **ctx_kw)

    def _pre_kwargs(ctx, pre):
        if not nystrom:
            return ctx["precond_kwargs"]
        U_local, chol_G, shift = pre
        return {"precond_apply": _nystrom_apply(U_local, chol_G, shift, ctx["grp"])}

    def _wrap(loc, state) -> ShardedCGState:
        return ShardedCGState(*state, n=loc.n_pad if n_true is None else n_true,
                              mesh_size=_mesh.axis_size(mesh, axis), shard=loc.me)

    @torch.no_grad()
    def build_pre(params, x):
        loc = _local(mesh, axis, params, x, None, None, n_true)
        k_nw, p_nw, white_var = _k.split_white(kernel, loc.params)
        diag_shift = noise_variance + (white_var if white_var is not None else 0.0)
        return (*_nystrom_pre(loc, k_nw, p_nw, diag_shift, precond_rank, n_true), diag_shift)

    @torch.no_grad()
    def start(params, x, y, x_test, pre):
        loc, ctx = _ctx(params, x, y, x_test)
        state = _cg.cg_solve(ctx["matvec"], ctx["rhs"], tol=tol, max_iters=max_iters,
                             dot=ctx["pdot"], max_new_iters=segment_iters,
                             **_pre_kwargs(ctx, pre))
        bnorm = torch.sqrt(torch.max(ctx["pdot"](ctx["rhs"], ctx["rhs"])))
        return _wrap(loc, state), bnorm

    @torch.no_grad()
    def cont(params, x, y, x_test, pre, state):
        loc, ctx = _ctx(params, x, y, x_test)
        state = _cg.cg_solve(ctx["matvec"], ctx["rhs"], tol=tol, max_iters=max_iters,
                             dot=ctx["pdot"], init_state=state.cg_state(),
                             max_new_iters=segment_iters, **_pre_kwargs(ctx, pre))
        return _wrap(loc, state)

    @torch.no_grad()
    def finish(params, x, y, x_test, state):
        loc, ctx = _ctx(params, x, y, x_test)
        mean, var, alpha_local = _predict(kernel, loc, ctx["Ks_local"], state.x)
        return mean, var, alpha_local, state.iters, state.resnorm

    @torch.no_grad()
    def bnorm(params, x, y, x_test):
        _, ctx = _ctx(params, x, y, x_test)
        return torch.sqrt(torch.max(ctx["pdot"](ctx["rhs"], ctx["rhs"])))

    return {"build_pre": build_pre if nystrom else None, "start": start, "cont": cont,
            "finish": finish, "bnorm": bnorm}


def _check_resume(state: ShardedCGState, *, n, mesh_size, shard, m_local, width):
    want = (n, mesh_size, shard, (m_local, width))
    got = (state.n, state.mesh_size, state.shard, tuple(state.x.shape))
    if got != want:
        raise ValueError(
            "the resume state belongs to another problem: it has n={}, mesh size {}, shard {}, "
            "a block of shape {}; this call has n={}, mesh size {}, shard {}, a block of "
            "shape {}".format(*got, *want))


def distributed_posterior_cg_segmented(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    segment_iters: int = 40,
    dist_method: str = "dot",
    block_fn=None,
    preconditioner: str = "nystrom",
    precond_rank: int = 512,
    checkpoint_cb=None,
    resume_state: Optional[ShardedCGState] = None,
):
    """Segmented distributed posterior (mean and variance), resumable: the
    twin of ``gp.posterior_cg_segmented``. The preconditioner is built
    once; each segment runs at most ``segment_iters`` CG iterations over
    the ring matvec, and ``checkpoint_cb(segment_index, state)`` receives
    the rank's :class:`ShardedCGState` after each (persist it with
    ``utils.checkpoint.save(..., per_host=True)``). ``resume_state``
    continues a stopped solve exactly; a state of another problem (other
    n, mesh size, shard or RHS width) raises ``ValueError``. Pads any n and
    masks the padding.

    Returns ``(mean, var, alpha_local, iters, resnorm, state)``."""
    x_p, y_p, n_true = _mesh.pad_inputs(mesh, axis, x, y)
    x_test = _k._dist._as_2d(_mesh.to_mesh(mesh, x_test))
    segs = make_posterior_cg_segments(
        kernel, mesh=mesh, axis=axis, noise_variance=noise_variance, tol=tol,
        max_iters=max_iters, segment_iters=segment_iters, dist_method=dist_method,
        block_fn=block_fn, n_true=n_true, preconditioner=preconditioner,
        precond_rank=precond_rank)
    if resume_state is not None:
        p = _mesh.axis_size(mesh, axis)
        _check_resume(resume_state, n=n_true or x_p.shape[0], mesh_size=p,
                      shard=mesh.get_local_rank(axis), m_local=x_p.shape[0] // p,
                      width=1 + x_test.shape[0])
    pre = segs["build_pre"](params, x_p) if segs["build_pre"] is not None else None
    seg_i = 0
    if resume_state is None:
        state, bnorm = segs["start"](params, x_p, y_p, x_test, pre)
    else:
        state = segs["cont"](params, x_p, y_p, x_test, pre, resume_state)
        bnorm = segs["bnorm"](params, x_p, y_p, x_test)
    stop = float(tol) * max(float(bnorm), 1e-30)
    if checkpoint_cb is not None:
        checkpoint_cb(seg_i, state)
    while float(state.resnorm) > stop and state.iters < max_iters:
        prev = state.iters
        state = segs["cont"](params, x_p, y_p, x_test, pre, state)
        seg_i += 1
        if checkpoint_cb is not None:
            checkpoint_cb(seg_i, state)
        if state.iters == prev:
            break  # the cap was reached inside
    mean, var, alpha, iters, resnorm = segs["finish"](params, x_p, y_p, x_test, state)
    return mean, var, alpha, iters, resnorm, state


def distributed_posterior_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    noise_variance: float = 5e-4,
    tol: float = 1e-6,
    max_iters: int = 1000,
    dist_method: str = "dot",
    block_fn=None,
    preconditioner: str = "jacobi",
    precond_rank: int = 512,
):
    """One-shot :func:`make_posterior_cg` (mean and variance) on any n: pads
    the inputs and masks the padding. Returns (mean, var, alpha_local,
    iters, resnorm)."""
    x_p, y_p, n_true = _mesh.pad_inputs(mesh, axis, x, y)
    solver = make_posterior_cg(
        kernel, mesh=mesh, axis=axis, noise_variance=noise_variance, tol=tol,
        max_iters=max_iters, dist_method=dist_method, block_fn=block_fn, n_true=n_true,
        preconditioner=preconditioner, precond_rank=precond_rank)
    return solver(params, x_p, y_p, x_test)
