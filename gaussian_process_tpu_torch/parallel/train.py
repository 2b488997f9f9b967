"""Distributed LML training step (torch counterpart of
``parallel/train.py``): one step of hyperparameter ascent over a
(restart, data) mesh.

- The candidate batch is sharded over ``restart``: each rank steps the
  candidates of its restart group, one ``torch.optim`` optimiser each.
- X and y are row-sharded over ``data``: each rank builds its kernel
  block-row (the tile gram on the card, whose backward is one launch of
  its CUDA backward kernel), and the block-rows are gathered by a
  differentiable all-gather (its backward reduce-scatters the cotangent)
  into the K every rank factors alike, in ``linalg.cholesky.solve_dtype``
  (float64 for fp32 inputs, as the single-card LML; the JAX step factors
  in the input dtype).

The gradient is the gradient of the LML. Every rank computes the same LML
from the gathered K, so the gather's backward sums p equal cotangents: the
objective is divided by p before the backward, and each rank's share of the
params gradient (through its own block-row) is summed over the data axis
before the update. (The JAX step differentiates the replicated LML inside
``shard_map`` without that sum, so on a data axis of more than one device
each device steps with only its own rows' share, and the mesh sizes
disagree; the port's step equals the one-device step at every size.)
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.opt import gradient as _grad
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.parallel import mesh as _mesh
from gaussian_process_tpu_torch.parallel.kernel_blocks import _local_block_row
from gaussian_process_tpu_torch.parallel.restarts import _gather_batch, _local_candidates


class TrainStepResult(NamedTuple):
    params: Any  # the updated candidate batch, whole on every rank
    opt_state: Any  # this rank's optimisers, one per local candidate
    lml: torch.Tensor  # (R,) LML of each candidate before the update


class _GatherRows(torch.autograd.Function):
    """All ranks' block-rows stacked in rank order (``lax.all_gather``,
    tiled), differentiable: the backward reduce-scatters the cotangent, each
    rank keeping the sum of its own rows (``reduce_scatter_tensor`` under
    NCCL; gloo has no reduce-scatter, so an all-reduce and a slice).
    ``torch.distributed.nn.functional.all_gather`` is not used: under gloo
    its backward names the roots of its scatters by global rank, which fails
    in a sub-group that lacks rank 0 (torch 2.13), as a restart group's data
    axis does."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return _mesh.all_gather_rows(t, grp)

    @staticmethod
    def backward(ctx, ct):
        grp = ctx.grp
        p = dist.get_world_size(grp)
        m = ct.shape[0] // p
        ct = ct.contiguous()
        if dist.get_backend(grp) == dist.Backend.NCCL:
            out = torch.empty((m,) + tuple(ct.shape[1:]), dtype=ct.dtype, device=ct.device)
            dist.reduce_scatter_tensor(out, ct, group=grp)
            return out, None
        me = dist.get_rank(grp)
        return _mesh.all_reduce(ct.clone(), grp)[me * m:(me + 1) * m], None


def make_distributed_train_step(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    noise_variance: float = 5e-4,
    learning_rate: float = 0.01,
    optimizer: str = "adam",
    transform: str = "log",
    data_axis: str = "data",
    restart_axis: str = "restart",
    dist_method: str = "dot",
):
    """Returns ``(step_fn, init_fn)``.

    ``init_fn(params_batch) -> opt_state``: this rank's optimisers
    (``opt.gradient.make_optimizer``: Adam, optax's rule, or SGD), one per
    candidate of its restart slice, over the candidates' params in the
    optimisation space (log-params for ``transform="log"``).
    ``step_fn(params_batch, opt_state, x, y) -> TrainStepResult``:
    ``params_batch`` leaves carry a leading batch dimension that the
    restart axis divides; ``x``, ``y`` are global with a length the data
    axis divides. The optimisers keep their moments across steps; the
    step reads the params it is given, as the JAX step does.
    """
    to_opt = _grad.log_params if transform == "log" else (lambda p: p)
    from_opt = _grad.exp_params if transform == "log" else (lambda p: p)
    grp = mesh.get_group(data_axis)
    p_data = _mesh.axis_size(mesh, data_axis)

    def _lml(op_params, x_local, x_full, y_full):
        k_nw, p_nw, white_var = _k.split_white(kernel, from_opt(op_params))
        me = mesh.get_local_rank(data_axis)
        K_row = _local_block_row(k_nw, p_nw, x_local, x_full, me * x_local.shape[0], white_var,
                                 dist_method)
        K = _GatherRows.apply(K_row, grp)
        dtype = K.dtype
        work = _chol.solve_dtype(dtype)
        L = _chol.safe_cholesky(K.to(work), initial_jitter=noise_variance,
                                min_retry_jitter=10.0 * torch.finfo(dtype).eps).factor
        y_w = y_full.to(work)
        alpha = _chol.cholesky_solve(L, y_w)
        n = y_full.shape[0]
        lml = (-0.5 * torch.dot(y_w, alpha) - torch.sum(torch.log(torch.diagonal(L)))
               - 0.5 * n * math.log(2.0 * math.pi))
        return lml.to(dtype)

    def init_fn(params_batch):
        return [_grad.make_optimizer(optimizer, _grad.trainable_leaves(p, to_opt), learning_rate)
                for p in _local_candidates(mesh, restart_axis, params_batch)]

    def step_fn(params_batch, opt_state, x, y) -> TrainStepResult:
        x = _k._dist._as_2d(_mesh.to_mesh(mesh, x))
        x_local = _mesh.local_rows(mesh, x, data_axis)
        x_full = _mesh.all_gather_rows(x_local, grp)
        y_full = _mesh.all_gather_rows(
            _mesh.local_rows(mesh, _mesh.to_mesh(mesh, y), data_axis), grp)
        results = []
        for p, opt in zip(_local_candidates(mesh, restart_axis, params_batch), opt_state):
            leaves = opt.param_groups[0]["params"]
            with torch.no_grad():
                for leaf, value in zip(leaves, _k.tree_leaves(to_opt(p))):
                    leaf.copy_(value)
            opt.zero_grad()
            lml = _lml(_k.tree_unflatten(p, leaves), x_local, x_full, y_full)
            (-lml / p_data).backward()  # ascend; the gather's backward sums p copies
            for leaf in leaves:
                leaf.grad = _mesh.all_reduce(leaf.grad, grp)
            opt.step()
            new = from_opt(_k.tree_unflatten(p, [leaf.detach().clone() for leaf in leaves]))
            results.append((new, lml.detach()))
        params, lml = _gather_batch(mesh, restart_axis, results)
        return TrainStepResult(params=params, opt_state=opt_state, lml=lml)

    return step_fn, init_fn
