"""Data-partitioned kernel blocks (torch counterpart of
``parallel/kernel_blocks.py``).

X is sharded by rows over the ``data`` axis of the mesh; each rank builds
its block-row K[rows_local, :] (the tile gram on the card) and the ring
matvec streams the other ranks' (x, v) blocks past its own rows, so the
global K never exists anywhere.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops
from gaussian_process_tpu_torch.parallel import mesh as _mesh


def _local_block_row(kernel, params, x_local, x_full, row_offset, white_var, dist_method):
    """K[rows_local, :] with ``white_var`` on the global diagonal (entries
    (i, row_offset + i)). The gram is ``kops.gram``: the tile gram for fp32
    CUDA inputs, differentiable through its backward kernel."""
    Kb = _kops.gram(kernel, params, x_local, x_full, method=dist_method)
    if white_var is not None:
        Kb = Kb.clone()
        Kb.diagonal(offset=row_offset).add_(white_var)
    return Kb


def sharded_gram(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    dist_method: str = "dot",
) -> torch.Tensor:
    """This rank's block-row of K(x, x): rows ``me * n/p`` to
    ``(me + 1) * n/p`` of the full matrix, White on its global diagonal.
    ``x`` is the global input, whose leading dimension must divide the axis
    (see ``mesh.pad_to_multiple``); :func:`mesh.gather_rows` assembles K."""
    k_nw, p_nw, white_var = _k.split_white(kernel, _mesh.params_to_mesh(mesh, params))
    x_local = _mesh.shard_rows(mesh, x, axis)
    x_full = _mesh.all_gather_rows(x_local, mesh.get_group(axis))
    me = mesh.get_local_rank(axis)
    return _local_block_row(k_nw, p_nw, x_local, x_full, me * x_local.shape[0], white_var,
                            dist_method)


def ring_apply(
    block: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    x_local: torch.Tensor,
    v_local: torch.Tensor,
    grp,
) -> torch.Tensor:
    """sum over the ring of ``block(x_local, xb, vb)``: at step s the
    (xb, vb) in hand is rank (me - s)'s. Double-buffered: the transfer of
    the next block (send to rank + 1, receive from rank - 1) is posted
    before the current block's product, so the copy overlaps the kernel.
    p - 1 transfers a call (none goes back to its owner); at one rank the
    ring is the identity and posts no point-to-point operation, which
    neither NCCL nor gloo takes to oneself."""
    p = dist.get_world_size(grp)
    me = dist.get_rank(grp)
    nxt = dist.get_global_rank(grp, (me + 1) % p)
    prv = dist.get_global_rank(grp, (me - 1) % p)
    xb, vb = x_local.contiguous(), v_local.contiguous()
    acc = None
    for step in range(p):
        last = step == p - 1
        if not last:
            xn, vn = torch.empty_like(xb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, xb, nxt, grp),
                dist.P2POp(dist.isend, vb, nxt, grp),
                dist.P2POp(dist.irecv, xn, prv, grp),
                dist.P2POp(dist.irecv, vn, prv, grp),
            ])
        part = block(x_local, xb, vb)
        acc = part if acc is None else acc + part
        if not last:
            for req in reqs:
                req.wait()
            xb, vb = xn, vn
    return acc


def ring_matvec(
    kernel: _k.Kernel,
    params: _k.Params,
    x: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "data",
    dist_method: str = "dot",
    block_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """This rank's rows of K(x, x) @ v, with x and v row-sharded over
    ``axis`` and K never materialised: the ring pattern of
    :func:`ring_apply` (O(n^2 / p) work and O(n) traffic a rank).
    ``block_fn(x_local, xb, vb) -> K(x_local, xb) @ vb`` overrides the local
    product, by default the plain gram product (``cg._auto_block`` gives the
    solvers the CUDA full sweep). ``x`` and ``v`` are global."""
    k_nw, p_nw, white_var = _k.split_white(kernel, _mesh.params_to_mesh(mesh, params))
    if block_fn is None:
        def block_fn(xl, xb, vb):
            return _kops.gram(k_nw, p_nw, xl, xb, method=dist_method) @ vb

    x_local = _mesh.shard_rows(mesh, x, axis)
    v_local = _mesh.shard_rows(mesh, v, axis)
    acc = ring_apply(block_fn, x_local, v_local, mesh.get_group(axis))
    if white_var is not None:
        acc = acc + white_var * v_local
    return acc
