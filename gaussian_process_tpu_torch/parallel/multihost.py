"""Multi-host bring-up and host coordination on ``torch.distributed``
(torch counterpart of ``parallel/multihost.py``).

Every process connects to a TCP store that the coordinator, process 0,
hosts (as JAX's coordination service lives on process 0), joins one
process group over it, and then runs the same ``parallel`` programs as on
one host: the mesh of :func:`global_mesh` spans every process.

Bring-up order (each process):

    multihost.initialize(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh(restart=R)
    x    = multihost.host_local_to_global(mesh, x_local)   # this process's rows
    ...the same parallel programs as on one host...

Failure detection: :func:`sync_hosts` with a timeout is a check-in on the
store that raises on every survivor when a process has died, instead of
hanging in a collective (NCCL has no per-call barrier timeout). After such
a failure the survivors must not touch the broken group again: they call
:func:`shutdown`, build a mesh of their own (``parallel.make_mesh`` opens a
one-rank group) and re-dispatch the lost work
(``parallel.run_with_redispatch``). Per-rank checkpoints are
``utils.checkpoint.save(..., per_host=True)``, one ``.rank<r>`` file a
process.
"""

from __future__ import annotations

import collections
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gaussian_process_tpu_torch.parallel import mesh as _mesh

# what initialize set up: the coordinator's store, and how often each
# barrier name was used (the check-in keys)
_STATE = {"store": None, "uses": collections.Counter()}
# how long live_hosts waits for every process to check in
_LIVE_TIMEOUT_S = 10.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Join this process to the process group (idempotent: nothing happens
    where a group exists).

    The arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator's ``host:port``, ``WORLD_SIZE`` and
    ``RANK``. Process 0 hosts the TCP store at that address.
    ``device=None`` means NCCL on ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
    defaulting to the process id modulo the cards of the host);
    ``device="cpu"`` means gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("no coordinator address: pass host:port or set MASTER_ADDR and "
                         "MASTER_PORT")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    dev = _mesh._device(device)
    kwargs = {}
    if dev.type == "cuda":
        local = dev.index
        if local is None:
            local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world_size=num_processes,
                          is_master=process_id == 0)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            **kwargs)
    _STATE.update(store=store, uses=collections.Counter())


def shutdown() -> None:
    """Destroy the process group. The error that a dead peer causes is
    ignored: a survivor tears its side down all the same."""
    _STATE.update(store=None, uses=collections.Counter())
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except RuntimeError:  # torch.distributed's errors, a dead peer's among them
            pass


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(*, restart: int = 1, data: Optional[int] = None) -> DeviceMesh:
    """The (restart, data) mesh over every process of the group (the same
    on each; call after :func:`initialize`), on the group's device: the
    card under NCCL, the CPU under gloo."""
    device = "cpu" if dist.is_initialized() and dist.get_backend() == "gloo" else None
    return _mesh.make_mesh(restart=restart, data=data, device=device)


def host_local_to_global(mesh: DeviceMesh, local, axis: str = "data") -> torch.Tensor:
    """The global tensor from every process's rows along ``axis``: each
    process passes its own block (all of equal length), and every process
    gets them all, stacked in rank order."""
    return _mesh.all_gather_rows(_mesh.to_mesh(mesh, local), mesh.get_group(axis))


def replicate_to_global(mesh: DeviceMesh, value) -> torch.Tensor:
    """``value`` on every process as the mesh's first process holds it."""
    return _mesh.replicated(mesh, value)


def global_to_host_local(mesh: DeviceMesh, garray: torch.Tensor, axis: str = "data"
                         ) -> np.ndarray:
    """This process's rows of a global tensor along ``axis``, in host
    memory (the inverse of :func:`host_local_to_global`)."""
    return _mesh.local_rows(mesh, garray, axis).detach().cpu().numpy()


def fetch_replicated(garray) -> np.ndarray:
    """Host copy of a value that every process holds alike."""
    if isinstance(garray, torch.Tensor):
        return garray.detach().cpu().numpy()
    return np.asarray(garray)


def _store():
    if _STATE["store"] is not None:
        return _STATE["store"]
    # a group opened elsewhere (torchrun's env init, parallel.make_mesh)
    return dist.distributed_c10d._get_default_store()


def _check_in(kind: str, name: str) -> tuple:
    """Count this process in at the next use of ``name`` and return (store,
    key); the last to arrive sets ``<key>/done``. Every process uses the
    names in the same order, so the use counts agree."""
    store = _store()
    _STATE["uses"][(kind, name)] += 1
    key = f"gp_{kind}/{name}/{_STATE['uses'][(kind, name)]}"
    store.set(f"{key}/{dist.get_rank()}", "1")
    if store.add(key, 1) == dist.get_world_size():
        store.set(f"{key}/done", "1")
    return store, key


def sync_hosts(name: str = "sync", *, timeout_s: Optional[float] = None) -> None:
    """Barrier across all processes, and failure detection in practice.

    With ``timeout_s`` every process checks in on the coordinator's store
    and waits at most that long for the others: where a process has died,
    this raises on every survivor (``torch.distributed.DistStoreError``,
    or a connection error where the coordinator itself is gone) instead of
    hanging, which is the signal to fail over. Without it, this is
    ``dist.barrier()``. Without a group there is nothing to synchronise."""
    if not dist.is_initialized():
        return
    if timeout_s is None:
        dist.barrier()
        return
    store, key = _check_in("sync", name)
    store.wait([f"{key}/done"], timedelta(seconds=timeout_s))


def live_hosts() -> list:
    """The process ids that check in within ``_LIVE_TIMEOUT_S`` seconds
    (every live process calls this): ``list(range(world))`` while all are up, the
    survivors after a death; ``[0]`` without a group. After a death,
    survivors rebuild their work assignment over this set
    (``parallel.recovery``)."""
    if not dist.is_initialized():
        return [0]
    store, key = _check_in("live", "hosts")
    try:
        store.wait([f"{key}/done"], timedelta(seconds=_LIVE_TIMEOUT_S))
    except dist.DistStoreError:
        pass  # a process that never checks in is not live
    return [r for r in range(dist.get_world_size()) if store.check([f"{key}/{r}"])]
