"""One process of the port's multi-host loopback test (started by
``tests/test_torch_multihost.py``; not collected by pytest). It imports
torch, numpy and the port only.

    python tests/torch_multihost_worker.py <host:port> <processes> <id> <work dir>

Brings up ``parallel.multihost`` on gloo over TCP on localhost and runs,
with the process boundary inside the mesh: a (restart, data) mesh over
every process, a sharded LML with one candidate a process, the exact
distributed posterior and the block-CG posterior at an uneven n whose rows
each process passes as its own block, barriers, ``live_hosts`` and a
per-rank checkpoint. It pickles what the test holds against the JAX
package to ``<work dir>/rank<id>.pkl`` and prints ``WORKER_OK <id>``.
"""

import os
import pickle
import sys

import numpy as np
import torch

N_UNEVEN = 51  # does not divide two processes: masked padding


def data():
    """The inputs, the same on every process and in the test."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-5, 5, (24, 2))
    y = np.sin(0.9 * x.sum(axis=1))
    xu = rng.uniform(-5, 5, (N_UNEVEN, 2))
    yu = np.sin(0.9 * xu.sum(axis=1))
    cand = {"sigma": np.asarray([1.0, 2.0]), "lengthscale": np.asarray([1.0, 0.5])}
    return x, y, xu, yu, xu[:6] + 0.05, cand


def run(nproc, pid, workdir) -> dict:
    """Everything between bring-up and shutdown; its meshes go when it
    returns, before the group does."""
    from gaussian_process_tpu_torch import ops, parallel
    from gaussian_process_tpu_torch.parallel import multihost
    from gaussian_process_tpu_torch.utils import checkpoint

    out = {}
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    x, y, xu, yu, x_test, cand = data()
    kernel = ops.RBF()

    # one candidate a process along the restart axis, each passing its own
    mesh = multihost.global_mesh(restart=nproc)
    out["mesh_shape"] = list(mesh.shape)
    out["mesh_names"] = list(mesh.mesh_dim_names)
    batch = {k: multihost.host_local_to_global(mesh, t(v[pid:pid + 1]), axis="restart")
             for k, v in cand.items()}
    lml = parallel.make_sharded_lml(kernel, mesh=mesh)(
        batch, multihost.replicate_to_global(mesh, t(x)),
        multihost.replicate_to_global(mesh, t(y)))
    out["lml"] = multihost.fetch_replicated(lml)
    out["batch_lengthscale"] = multihost.fetch_replicated(batch["lengthscale"])

    multihost.sync_hosts("after-lml")
    multihost.sync_hosts("after-lml", timeout_s=30)
    out["live"] = multihost.live_hosts()

    # the data axis across the processes, each passing its rows of the
    # padded inputs
    flat = multihost.global_mesh(restart=1)
    out["flat_shape"] = list(flat.shape)
    n_pad = -(-N_UNEVEN // nproc) * nproc
    xu_p, _ = parallel.pad_to_multiple(t(xu), nproc)
    yu_p, _ = parallel.pad_to_multiple(t(yu), nproc)
    rows = slice(pid * (n_pad // nproc), (pid + 1) * (n_pad // nproc))
    xg = multihost.host_local_to_global(flat, xu_p[rows])
    yg = multihost.host_local_to_global(flat, yu_p[rows])
    out["gathered_equal"] = bool(torch.equal(xg, xu_p) and torch.equal(yg, yu_p))
    xt = multihost.replicate_to_global(flat, t(x_test))
    params = {"sigma": t(1.0), "lengthscale": t(1.0)}
    exact = parallel.make_distributed_posterior(kernel, mesh=flat, noise_variance=1e-4,
                                                n_true=N_UNEVEN)
    mean, var, lml_post, alpha = exact(params, xg, yg, xt)
    out["exact"] = {"mean": multihost.fetch_replicated(mean),
                    "var": multihost.fetch_replicated(var),
                    "lml": float(lml_post), "alpha_rows": alpha.shape[0],
                    "y_rows": multihost.global_to_host_local(flat, yg)}
    cg = parallel.make_posterior_cg(kernel, mesh=flat, noise_variance=1e-4, tol=1e-10,
                                    max_iters=200, n_true=N_UNEVEN)
    mean_g, var_g, _, iters, _ = cg(params, xg, yg, xt)
    out["cg"] = {"mean": multihost.fetch_replicated(mean_g),
                 "var": multihost.fetch_replicated(var_g), "iters": iters}

    # a per-rank checkpoint, saved and restored
    state = {"pid": torch.tensor(pid), "lml": lml, "alpha": alpha}
    path = checkpoint.save(os.path.join(workdir, "ckpt"), state, step=1)
    multihost.sync_hosts("saved", timeout_s=30)
    like = {"pid": torch.tensor(-1), "lml": torch.zeros_like(lml),
            "alpha": torch.zeros_like(alpha)}
    back = checkpoint.restore(os.path.join(workdir, "ckpt"), like, step=1)
    out["ckpt"] = {"file": os.path.basename(path), "pid": int(back["pid"]),
                   "equal": bool(torch.equal(back["lml"], lml)
                                 and torch.equal(back["alpha"], alpha))}

    multihost.sync_hosts("done", timeout_s=30)
    return out


def main() -> None:
    coordinator, nproc, pid, workdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gaussian_process_tpu_torch.parallel import multihost

    multihost.initialize(coordinator, nproc, pid, device="cpu")
    multihost.initialize(coordinator, nproc, pid, device="cpu")  # idempotent
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    assert multihost.is_coordinator() == (pid == 0)
    out = run(nproc, pid, workdir)
    with open(os.path.join(workdir, f"rank{pid}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    multihost.shutdown()
    assert not dist.is_initialized()
    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
