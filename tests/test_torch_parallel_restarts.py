"""The port's sharded restarts (``parallel/restarts.py``) and distributed
training step (``parallel/train.py``) against the JAX package's, with 1, 2
and 4 gloo ranks, in float64."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gaussian_process_tpu import gp, ops, parallel
from gaussian_process_tpu.parallel.train import make_distributed_train_step

WORLDS = (1, 2, 4)
ELLS = [0.3, 0.6, 1.0, 1.4, 1.8, 2.2, 2.6, 3.0]
TRAIN = dict(n=16, d=2, seed=0, steps=3, kernel="rbf_white", lr=0.05)
CASES = {
    "restarts": ("restarts", dict(n=20, d=1, seed=5, ells=ELLS, max_iters=200)),
    "train": ("train", dict(restart=1, lengthscales=[1.3], **TRAIN)),
    "train_restarts": ("train", dict(restart=2, lengthscales=[1.3, 0.7], **TRAIN), (2, 4)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("restarts"))


def _batch(ells):
    return {"sigma": jnp.ones(len(ells)), "lengthscale": jnp.asarray(ells)}


@pytest.mark.parametrize("P", WORLDS)
def test_torch_sharded_lml_matches_jax(runs, P):
    x, y = map(jnp.asarray, ranks.data(20, 1, 5))
    mesh = parallel.make_mesh(restart=P, data=1, devices=jax.devices()[:P])
    want = np.asarray(parallel.sharded_lml(ops.RBF(), _batch(ELLS), x, y, mesh=mesh))
    serial = [float(gp.log_marginal_likelihood(
        ops.RBF(), {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(e)}, x, y,
        noise_variance=5e-4)) for e in ELLS]
    for res in ranks.ok(runs[P]["restarts"]):
        np.testing.assert_allclose(res["lml"], want, rtol=1e-9)
        np.testing.assert_allclose(res["lml"], serial, rtol=1e-9)


@pytest.mark.parametrize("P", WORLDS)
def test_torch_sharded_gradient_restarts_match_jax(runs, P):
    x, y = map(jnp.asarray, ranks.data(20, 1, 5))
    mesh = parallel.make_mesh(restart=P, data=1, devices=jax.devices()[:P])
    params, lml, iters, conv = parallel.sharded_gradient_restarts(
        ops.RBF(), _batch(ELLS), x[:16], y[:16], mesh=mesh, max_iters=200,
        trainable={"sigma": False, "lengthscale": True})
    for res in ranks.ok(runs[P]["restarts"]):
        np.testing.assert_array_equal(res["iters"], np.asarray(iters))
        np.testing.assert_array_equal(res["converged"], np.asarray(conv))
        np.testing.assert_allclose(res["params"]["lengthscale"], np.asarray(params["lengthscale"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(res["params"]["sigma"], 1.0)
        np.testing.assert_allclose(res["lml_out"], np.asarray(lml), rtol=1e-6)
        assert np.all(res["lml_out"] >= res["lml_in"] - 1e-9)
        i = int(np.argmax(res["lml_out"]))
        assert res["best_v"] == res["lml_out"][i]
        assert res["best"] == res["params"]["lengthscale"][i]


@functools.lru_cache(maxsize=None)
def _jax_train(lengthscales):
    """The JAX step on a data axis of one device, where its gradient is the
    LML's (see test_torch_distributed_train_step_is_mesh_size_invariant)."""
    x, y = map(jnp.asarray, ranks.data(TRAIN["n"], TRAIN["d"], TRAIN["seed"]))
    R = len(lengthscales)
    mesh = parallel.make_mesh(restart=R, data=1, devices=jax.devices()[:R])
    step, init = make_distributed_train_step(ops.RBF() + ops.White(), mesh=mesh,
                                             learning_rate=TRAIN["lr"])
    batch = ({"sigma": jnp.ones(R), "lengthscale": jnp.asarray(lengthscales)},
             {"amplitude": jnp.full((R,), 0.1)})
    opt_state = init(batch)
    lmls, params = [], []
    for _ in range(TRAIN["steps"]):
        res = step(batch, opt_state, x, y)
        batch, opt_state = res.params, res.opt_state
        lmls.append(np.asarray(res.lml))
        params.append([np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(batch)])
    return np.stack(lmls), params


@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_train_step_matches_jax(runs, P):
    lml, params = _jax_train((1.3,))
    for res in ranks.ok(runs[P]["train"]):
        assert res["local_optimisers"] == 1
        np.testing.assert_allclose(res["lml"], lml, rtol=1e-9)
        for got, want in zip(res["params"], params):
            # the port's tree_leaves visits the dict in insertion order
            # (sigma, lengthscale), JAX's sorted (lengthscale, sigma)
            np.testing.assert_allclose(got, [want[1], want[0], want[2]], rtol=1e-9)


@pytest.mark.parametrize("P", (2, 4))
def test_torch_distributed_train_step_shards_restarts(runs, P):
    lml, params = _jax_train((1.3, 0.7))
    results = ranks.ok(runs[P]["train_restarts"])
    for res in results:
        assert res["local_optimisers"] == 1
        np.testing.assert_allclose(res["lml"], lml, rtol=1e-9)
        np.testing.assert_allclose(res["params"][-1], [params[-1][1], params[-1][0],
                                                       params[-1][2]], rtol=1e-9)


def test_torch_distributed_train_step_is_mesh_size_invariant(runs):
    """The port's step sums the ranks' shares of the gradient, so 4 ranks
    on the data axis step as one does. (The JAX step does not: on a data
    axis of 4 devices its trajectory leaves the one-device one, which is
    why the JAX side of these tests runs on a data axis of one.)"""
    one = ranks.ok(runs[1]["train"])[0]
    for res in ranks.ok(runs[4]["train"]):
        np.testing.assert_allclose(res["lml"], one["lml"], rtol=1e-10)
        for got, want in zip(res["params"], one["params"]):
            np.testing.assert_allclose(got, want, rtol=1e-10)
