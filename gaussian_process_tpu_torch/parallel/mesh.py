"""Process mesh for the multi-device tier (torch counterpart of
``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and lets
``shard_map`` hand each device its block. Here a rank is one process of
``torch.distributed``, the mesh is a ``DeviceMesh`` over the ranks with the
JAX axis names ``("restart", "data")``, and each entry point of
``parallel`` runs the SPMD body in every rank:

- ``data`` shards kernel-matrix block-rows and training points;
- ``restart`` shards independent hyperparameter-search restarts.

Calling convention of the entry points: every rank passes the same global
``x``, ``y`` and ``x_test``, as the JAX calls do, and takes its own row
block. Results that the JAX package returns replicated come back equal on
every rank; row-sharded ones (``alpha``, the CG state) come back as the
rank's block, which :func:`gather_rows` assembles.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("restart", "data")


def _device(device) -> torch.device:
    """``None`` means the card, as for the estimators."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh was asked for the card, but CUDA is not available; "
                           "pass device='cpu' for a CPU mesh")
    return dev


def make_mesh(
    *,
    data: Optional[int] = None,
    restart: Optional[int] = None,
    cfg=None,
    device=None,
) -> DeviceMesh:
    """Build a (restart, data) mesh over the ranks of ``torch.distributed``.
    ``data=None`` puts every remaining rank on the data axis; ``cfg``
    (``config.MeshConfig``) supplies axis sizes, explicit arguments win.

    ``device=None`` means the card with an NCCL group; ``device="cpu"`` a
    CPU mesh with gloo. Where no process group exists yet this opens a
    one-rank group on an in-process store (the counterpart of a one-device
    JAX mesh). Where one exists, the mesh covers all of its ranks: unlike a
    JAX mesh, which may take the first ``restart * data`` devices, the axis
    sizes must multiply to the world size.
    """
    if cfg is not None:
        if data is None:
            data = cfg.data_axis_size
        if restart is None:
            restart = cfg.restart_axis_size
    if restart is None:
        restart = 1
    dev = _device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                    device_id=torch.device("cuda", torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if data is None:
        if world % restart:
            raise ValueError(f"{world} ranks not divisible by restart={restart}")
        data = world // restart
    if restart * data != world:
        raise ValueError(f"mesh {restart}x{data} does not cover the {world} ranks")
    return init_device_mesh(dev.type, (restart, data), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def to_mesh(mesh: DeviceMesh, t) -> torch.Tensor:
    """``t`` as a tensor on this rank's device, dtype kept."""
    return torch.as_tensor(t).to(mesh_device(mesh))


def params_to_mesh(mesh: DeviceMesh, params):
    """A params tree with every tensor leaf on this rank's device."""
    from gaussian_process_tpu_torch.ops import kernels as _k

    dev = mesh_device(mesh)
    return _k.tree_map_params(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a, params)


def local_rows(mesh: DeviceMesh, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's block of the rows of the global ``t`` (whose leading
    dimension the axis size must divide)."""
    p = axis_size(mesh, axis)
    n = t.shape[0]
    if n % p:
        raise ValueError(f"{n} rows do not divide the {axis} axis of size {p}; "
                         "pad them first (pad_to_multiple)")
    m = n // p
    me = mesh.get_local_rank(axis)
    return t[me * m:(me + 1) * m]


def shard_rows(mesh: DeviceMesh, t, axis: str = "data") -> torch.Tensor:
    """This rank's row block of the global ``t``, on its device.

    The JAX function returns a ``NamedSharding`` for ``jax.device_put``; a
    rank of ``torch.distributed`` holds its block itself, so this returns
    the block."""
    return local_rows(mesh, to_mesh(mesh, t), axis)


def replicated(mesh: DeviceMesh, t) -> torch.Tensor:
    """``t`` on this rank's device as rank 0 of the mesh holds it.

    The JAX function returns a replicated ``NamedSharding``; here the value
    is broadcast from the mesh's first rank, so every rank holds equal
    bits."""
    out = to_mesh(mesh, t).contiguous().clone()
    dist.broadcast(out, src=int(mesh.mesh.flatten()[0]))
    return out


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros so it divides the mesh axis; returns
    ``(padded, original_len)``. The solvers mask the padding."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return F.pad(x, widths), n


def pad_inputs(mesh: DeviceMesh, axis: str, x, y):
    """Global ``x`` and ``y`` on this rank's device, padded to a multiple
    of the axis size, and ``n_true`` (None where no padding was needed) for
    the solvers' masks."""
    p = axis_size(mesh, axis)
    x = to_mesh(mesh, x)
    n = x.shape[0]
    x_p, _ = pad_to_multiple(x, p)
    y_p, _ = pad_to_multiple(to_mesh(mesh, y), p)
    return x_p, y_p, (None if x_p.shape[0] == n else n)


def all_gather_rows(t: torch.Tensor, grp) -> torch.Tensor:
    """The row blocks of every rank of ``grp`` stacked in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    p = dist.get_world_size(grp)
    t = t.contiguous()
    out = torch.empty((p * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    # torch 2.13 renames all_gather_into_tensor; older releases lack the new name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=grp)
    return out


def gather_rows(mesh: DeviceMesh, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Assemble a row-sharded result (``alpha``, a CG-state field) from
    every rank's block: the global tensor, on every rank."""
    return all_gather_rows(t, mesh.get_group(axis))


def all_reduce(t: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) over the ranks of ``grp`` (``lax.psum``, ``pmax``).
    Returns the result: ``t`` itself, reduced in place, where ``t`` is
    contiguous, else a contiguous copy (the collectives read raw storage,
    and a LAPACK result is laid out by columns)."""
    t = t.contiguous()
    dist.all_reduce(t, op=op, group=grp)
    return t
