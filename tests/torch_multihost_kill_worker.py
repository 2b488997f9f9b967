"""One process of the port's kill-one-host test (started by
``tests/test_torch_multihost.py``; not collected by pytest). It imports
torch, numpy and the port only.

    python tests/torch_multihost_kill_worker.py <host:port> 3 <id> <work dir>

Three processes bring up ``parallel.multihost`` on gloo over TCP on
localhost. Process 2 dies abruptly (``os._exit(17)``: no shutdown, no
atexit) after the first barrier. The survivors must

1. detect it: ``multihost.sync_hosts(timeout_s=8)`` raises on each instead
   of hanging;
2. recover: leave the broken group alone (``multihost.shutdown``), open a
   one-rank mesh of their own and re-dispatch, through
   ``parallel.run_with_redispatch``, their own candidate and (process 0)
   the dead one's.

Each survivor pickles its values to ``<work dir>/rank<id>.pkl`` for the
test to hold against the JAX package's LML.
"""

import os
import pickle
import sys

import numpy as np
import torch


def data():
    """The candidates (candidate i belongs to process i) and the inputs."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-5, 5, (16, 2))
    cand = {"sigma": np.asarray([1.0, 1.5, 2.0]), "lengthscale": np.asarray([1.0, 0.7, 0.5])}
    return cand, x, np.sin(0.9 * x.sum(axis=1))


def redispatch(batch, x, y):
    """``batch``'s LMLs through ``run_with_redispatch`` on a one-rank mesh
    of this process (gone when this returns, before its group)."""
    import torch.distributed as dist

    from gaussian_process_tpu_torch import ops, parallel

    local = parallel.make_mesh(device="cpu")
    assert dist.get_world_size() == 1
    lml_fn = parallel.make_sharded_lml(ops.RBF(), mesh=local)
    return parallel.run_with_redispatch(
        lambda b: lml_fn({k: torch.as_tensor(v) for k, v in b.items()}, torch.as_tensor(x),
                         torch.as_tensor(y)), batch)


def main() -> None:
    coordinator, nproc, pid, workdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4])
    assert nproc == 3
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gaussian_process_tpu_torch.parallel import multihost

    multihost.initialize(coordinator, nproc, pid, device="cpu")
    cand, x, y = data()
    owner = np.asarray([0, 1, 2])
    multihost.sync_hosts("all-up", timeout_s=60)
    if pid == 2:
        os._exit(17)  # a crashed host: no shutdown handshake, no atexit

    # 1. detect: the barrier raises on the survivors, it does not hang
    try:
        multihost.sync_hosts("after-work", timeout_s=8)
        detected = None
    except Exception as exc:
        detected = type(exc).__name__
        print(f"DETECTED {pid}: {detected}", flush=True)
    assert detected, "the barrier with a dead host did not raise on this survivor"

    # 2. recover on a mesh of this process alone
    multihost.shutdown()
    assert not dist.is_initialized()
    lost = [i for i in range(len(owner)) if owner[i] == 2]
    todo = sorted([i for i in range(len(owner)) if owner[i] == pid] + (lost if pid == 0 else []))
    res = redispatch({k: v[todo] for k, v in cand.items()}, x, y)
    assert res.ok.all(), res
    with open(os.path.join(workdir, f"rank{pid}.pkl"), "wb") as fh:
        pickle.dump({"todo": todo, "values": res.values, "detected": detected}, fh)
    dist.destroy_process_group()
    print(f"SURVIVOR_OK {pid} recovered={len(lost) if pid == 0 else 0}", flush=True)


if __name__ == "__main__":
    main()
