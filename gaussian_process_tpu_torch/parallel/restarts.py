"""Sharded hyperparameter-search restarts (torch counterpart of
``parallel/restarts.py``).

LML evaluations and gradient-ascent restarts are independent over the
candidates: each rank takes its slice of the candidate batch along the
``restart`` axis and loops over it with the single-card functions
(``gp.log_marginal_likelihood``, ``opt.tune_gradient_ascent``), with no
collective until the results are gathered. (The JAX package runs a local
``vmap``; a jitter-retrying Cholesky does not vmap in PyTorch, so the loop
is a Python loop.) Results come back whole, the full batch on every rank,
as the JAX global array holds it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.opt import gradient as _grad
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.parallel import mesh as _mesh


def _batch_size(params_batch) -> int:
    return int(_k.tree_leaves(params_batch)[0].shape[0])


def _local_candidates(mesh: DeviceMesh, axis: str, params_batch) -> List:
    """This rank's candidates along ``axis``, each a params tree on its
    device; the batch must divide the axis size."""
    params_batch = _mesh.params_to_mesh(
        mesh, _k.tree_map_params(torch.as_tensor, params_batch))
    size = _batch_size(params_batch)
    r = _mesh.axis_size(mesh, axis)
    if size % r:
        raise ValueError(f"a batch of {size} candidates does not divide the {axis} axis "
                         f"of size {r}")
    per = size // r
    me = mesh.get_local_rank(axis)
    return [_k.tree_map_params(lambda leaf, i=i: leaf[i], params_batch)
            for i in range(me * per, (me + 1) * per)]


def _gather_batch(mesh: DeviceMesh, axis: str, trees: List):
    """Stack the local results' leaves and gather them over ``axis``: the
    whole batch, in candidate order, on every rank."""
    grp = mesh.get_group(axis)

    def stacked(*leaves):
        t = torch.stack([torch.as_tensor(leaf, device=_mesh.mesh_device(mesh))
                         for leaf in leaves])
        if t.dtype == torch.bool:  # collectives carry numbers
            return _mesh.all_gather_rows(t.to(torch.int64), grp).to(torch.bool)
        return _mesh.all_gather_rows(t, grp)

    leaves = [_k.tree_leaves(tree) for tree in trees]
    gathered = [stacked(*column) for column in zip(*leaves)]
    return _k.tree_unflatten(trees[0], gathered)


def make_sharded_lml(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "restart",
    noise_variance: float = 5e-4,
    dist_method: str = "dot",
):
    """``(params_batch, x, y) -> lml (batch,)``: every rank evaluates its
    slice of the candidates along ``axis`` (the batch must divide the axis
    size)."""

    @torch.no_grad()
    def fn(params_batch, x, y):
        x = _mesh.to_mesh(mesh, x)
        y = _mesh.to_mesh(mesh, y)
        lml = [_reg.log_marginal_likelihood(kernel, p, x, y, noise_variance=noise_variance,
                                            dist_method=dist_method)
               for p in _local_candidates(mesh, axis, params_batch)]
        return _gather_batch(mesh, axis, [(v,) for v in lml])[0]

    return fn


def sharded_lml(
    kernel: _k.Kernel,
    params_batch: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "restart",
    noise_variance: float = 5e-4,
    dist_method: str = "dot",
) -> torch.Tensor:
    """LML for a batch of candidates (every leaf with a leading batch
    dimension), sharded over ``axis``; one-shot :func:`make_sharded_lml`."""
    fn = make_sharded_lml(kernel, mesh=mesh, axis=axis, noise_variance=noise_variance,
                          dist_method=dist_method)
    return fn(params_batch, x, y)


def make_sharded_gradient_restarts(
    kernel: _k.Kernel,
    *,
    mesh: DeviceMesh,
    axis: str = "restart",
    noise_variance: float = 5e-4,
    learning_rate: float = 0.01,
    tol: float = 1e-3,
    max_iters: int = 1000,
    optimizer: str = "adam",
    transform: str = "log",
    trainable=None,
):
    """``(params_batch, x, y) -> (params, lml, iters, converged)``:
    gradient-ascent LML maximisation from every candidate, each rank
    running ``opt.tune_gradient_ascent`` on its slice along ``axis``."""

    def fn(params_batch, x, y):
        x = _mesh.to_mesh(mesh, x)
        y = _mesh.to_mesh(mesh, y)
        results = []
        for p in _local_candidates(mesh, axis, params_batch):
            res = _grad.tune_gradient_ascent(
                kernel, p, x, y, noise_variance=noise_variance, learning_rate=learning_rate,
                tol=tol, max_iters=max_iters, optimizer=optimizer, transform=transform,
                trainable=trainable)
            results.append((res.params, res.lml, res.iters, res.converged))
        params, lml, iters, converged = _gather_batch(mesh, axis, results)
        return params, lml, iters, converged

    return fn


def sharded_gradient_restarts(
    kernel: _k.Kernel,
    params_batch: _k.Params,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "restart",
    noise_variance: float = 5e-4,
    learning_rate: float = 0.01,
    tol: float = 1e-3,
    max_iters: int = 1000,
    optimizer: str = "adam",
    transform: str = "log",
    trainable: Optional[object] = None,
):
    """One-shot :func:`make_sharded_gradient_restarts`; returns the
    per-restart (params, lml, iters, converged). Pick the winner with
    :func:`best_restart`."""
    fn = make_sharded_gradient_restarts(
        kernel, mesh=mesh, axis=axis, noise_variance=noise_variance,
        learning_rate=learning_rate, tol=tol, max_iters=max_iters, optimizer=optimizer,
        transform=transform, trainable=trainable)
    return fn(params_batch, x, y)


def best_restart(params_batch, lml: torch.Tensor):
    """The winning restart's params and LML (argmax, on the host)."""
    i = int(torch.argmax(torch.as_tensor(lml)))
    return _k.tree_map_params(lambda leaf: leaf[i], params_batch), float(lml[i])
