"""The port's multi-host bring-up (``parallel/multihost.py``) as processes
on one machine over TCP on localhost, gloo, held against the JAX package in
this process: a process-spanning mesh, a sharded LML and distributed
posteriors at an uneven n, barriers, ``live_hosts`` and per-rank
checkpoints (two processes); then three processes, one of which dies, whose
survivors detect the death at a barrier and re-dispatch its candidate."""

import os
import pickle
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

import torch_multihost_kill_worker as kill_worker
import torch_multihost_worker as worker
from gaussian_process_tpu import gp, ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(script, nproc, workdir, timeout=120):
    """Start ``nproc`` processes of ``script`` on one coordinator address;
    (return codes, outputs), every process gone."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, script.__file__, coord, str(nproc), str(i),
                               str(workdir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _load(workdir, pid):
    with open(os.path.join(workdir, f"rank{pid}.pkl"), "rb") as fh:
        return pickle.load(fh)


def _jax_lml(sigma, lengthscale, x, y):
    p = {"sigma": jnp.asarray(sigma), "lengthscale": jnp.asarray(lengthscale)}
    return float(gp.log_marginal_likelihood(ops.RBF(), p, jnp.asarray(x), jnp.asarray(y)))


def test_torch_two_process_loopback(tmp_path):
    rcs, outs = _run(worker, 2, tmp_path)
    for i, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0 and f"WORKER_OK {i}" in out, f"process {i}:\n{out}"
    x, y, xu, yu, x_test, cand = worker.data()
    lml = [_jax_lml(cand["sigma"][i], cand["lengthscale"][i], x, y) for i in range(2)]
    k = ops.RBF()
    post = gp.posterior(k, k.init_params(), jnp.asarray(xu), jnp.asarray(yu),
                        jnp.asarray(x_test), noise_variance=1e-4)
    results = [_load(tmp_path, i) for i in range(2)]
    for pid, res in enumerate(results):
        assert res["mesh_names"] == ["restart", "data"]
        assert res["mesh_shape"] == [2, 1] and res["flat_shape"] == [1, 2]
        np.testing.assert_array_equal(res["batch_lengthscale"], cand["lengthscale"])
        np.testing.assert_allclose(res["lml"], lml, rtol=1e-8)
        assert res["live"] == [0, 1]
        assert res["gathered_equal"]
        np.testing.assert_allclose(res["exact"]["mean"], np.asarray(post.mean), atol=1e-8)
        np.testing.assert_allclose(res["exact"]["var"], np.asarray(post.var), atol=1e-8)
        assert abs(res["exact"]["lml"] - float(post.lml)) < 1e-8
        assert res["exact"]["alpha_rows"] == 26
        np.testing.assert_array_equal(res["exact"]["y_rows"],
                                      np.concatenate([yu, [0.0]])[pid * 26:(pid + 1) * 26])
        np.testing.assert_allclose(res["cg"]["mean"], np.asarray(post.mean), atol=1e-6)
        np.testing.assert_allclose(res["cg"]["var"], np.asarray(post.var), atol=1e-6)
        assert res["ckpt"] == {"file": "step_00000001" + (".rank1" if pid else ""),
                               "pid": pid, "equal": True}
    np.testing.assert_array_equal(results[0]["exact"]["mean"], results[1]["exact"]["mean"])


def test_torch_kill_one_host_detect_and_redispatch(tmp_path):
    """Process 2 of 3 dies after the first barrier: both survivors raise
    from ``sync_hosts(timeout_s=8)``, leave the group, and re-dispatch on a
    mesh of their own; process 0 adopts the dead one's candidate."""
    rcs, outs = _run(kill_worker, 3, tmp_path)
    assert rcs[2] == 17, f"the dead process:\n{outs[2]}"
    cand, x, y = kill_worker.data()
    for i in (0, 1):
        assert rcs[i] == 0, f"survivor {i}:\n{outs[i]}"
        assert f"DETECTED {i}" in outs[i] and f"SURVIVOR_OK {i}" in outs[i], outs[i]
        res = _load(tmp_path, i)
        assert res["todo"] == ([0, 2] if i == 0 else [1])
        for value, c in zip(res["values"], res["todo"]):
            want = _jax_lml(cand["sigma"][c], cand["lengthscale"][c], x, y)
            assert abs(value - want) / abs(want) < 1e-8
    assert "recovered=1" in outs[0]
