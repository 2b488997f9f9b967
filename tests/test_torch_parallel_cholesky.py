"""The port's distributed panel Cholesky, block solves and exact posterior
(``parallel/cholesky.py``) against the JAX package's on a mesh of as many
devices, with 1, 2 and 4 gloo ranks, in float64, including an n that the
rank count does not divide and a White kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gaussian_process_tpu import gp, ops, parallel

WORLDS = (1, 2, 4)
CASES = {
    "chol64": ("chol", dict(n=64, seed=0)),
    "chol32": ("chol", dict(n=32, seed=1)),
    "solve48": ("chol_solve", dict(n=48, seed=2, cols=5)),
    "solve64": ("chol_solve", dict(n=64, seed=5, cols=16)),
    "post64": ("posterior", dict(n=64, d=3, t=16, seed=4, noise=5e-4, kernel="rbf")),
    "post32w": ("posterior", dict(n=32, d=1, t=8, seed=6, noise=5e-4, kernel="rbf_white2")),
    "post63": ("posterior", dict(n=63, d=2, t=17, seed=7, noise=1e-2, kernel="rbf")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("cholesky"))


def _jax_mesh(p):
    return parallel.make_mesh(restart=1, data=p, devices=jax.devices()[:p])


@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_cholesky_matches_jax(runs, P):
    K = jnp.asarray(ranks.spd(64, 0))
    want = np.asarray(parallel.distributed_cholesky(K, mesh=_jax_mesh(P)))
    for res in ranks.ok(runs[P]["chol64"]):
        assert res["rows"] == 64 // P
        np.testing.assert_allclose(res["L"], want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(res["L"], np.linalg.cholesky(np.asarray(K)),
                                   rtol=1e-10, atol=1e-12)


def test_torch_distributed_cholesky_mesh_size_invariance(runs):
    one = ranks.ok(runs[1]["chol32"])[0]["L"]
    for res in ranks.ok(runs[4]["chol32"]):
        np.testing.assert_allclose(res["L"], one, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_cholesky_solve_matches_jax(runs, P):
    kw = CASES["solve48"][1]
    K = ranks.spd(kw["n"], kw["seed"])
    rng = np.random.default_rng(kw["seed"] + 1)
    b = rng.standard_normal(kw["n"])
    B = rng.standard_normal((kw["n"], kw["cols"]))
    mesh = _jax_mesh(P)
    L = parallel.distributed_cholesky(jnp.asarray(K), mesh=mesh)
    want_x = np.asarray(parallel.distributed_cholesky_solve(L, jnp.asarray(b), mesh=mesh))
    want_X = np.asarray(parallel.distributed_cholesky_solve(L, jnp.asarray(B), mesh=mesh))
    for res in ranks.ok(runs[P]["solve48"]):
        np.testing.assert_allclose(K @ res["x"], b, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(K @ res["X"], B, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(res["x"], want_x, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(res["X"], want_X, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_cholesky_solve_wide_rhs(runs, P):
    """16 right-hand sides, each rank holding only its (n/p, 16) block of
    the solution (the JAX suite's 8-device case)."""
    kw = CASES["solve64"][1]
    K = ranks.spd(kw["n"], kw["seed"])
    rng = np.random.default_rng(kw["seed"] + 1)
    rng.standard_normal(kw["n"])
    B = rng.standard_normal((kw["n"], kw["cols"]))
    for res in ranks.ok(runs[P]["solve64"]):
        np.testing.assert_allclose(K @ res["X"], B, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("key", ["post64", "post32w", "post63"])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_exact_posterior_matches_jax(runs, P, key):
    kw = CASES[key][1]
    x, y, xt = map(jnp.asarray, ranks.problem(kw["n"], kw["d"], kw["t"], kw["seed"]))
    k = ops.RBF() if kw["kernel"] == "rbf" else ops.RBF() + ops.White()
    p = jax.tree_util.tree_map(jnp.asarray, ranks.kernel_spec(kw["kernel"]))
    mean, var, lml, alpha = parallel.distributed_posterior(
        k, p, x, y, xt, mesh=_jax_mesh(P), noise_variance=kw["noise"])
    single = gp.posterior(k, p, x, y, xt, noise_variance=kw["noise"])
    results = ranks.ok(runs[P][key])
    for res in results:
        assert res["alpha_rows"] == -(-kw["n"] // P)
        for want in ((mean, var, lml), (single.mean, single.var, single.lml)):
            np.testing.assert_allclose(res["mean"], np.asarray(want[0]), rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(res["var"], np.asarray(want[1]), rtol=1e-7, atol=1e-9)
            np.testing.assert_allclose(res["lml"], float(want[2]), rtol=1e-9)
        np.testing.assert_allclose(res["alpha"][:kw["n"]], np.asarray(single.alpha),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_array_equal(res["alpha"][kw["n"]:], 0.0)  # padding stays inert
    for res in results[1:]:
        assert res["lml"] == results[0]["lml"]
        np.testing.assert_array_equal(res["mean"], results[0]["mean"])
