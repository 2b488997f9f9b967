"""The port's distributed binary Laplace classifier
(``parallel/classification.py``: Newton over the ring, the re-weighted
sharded Nyström, the block-CG variance) against the JAX package's on a mesh
of as many devices, with 1, 2 and 4 gloo ranks, in float64, at an n that
the rank counts divide (96) and one they do not (61), with and without a
White term."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gaussian_process_tpu import ops, parallel

WORLDS = (1, 2, 4)
SETTINGS = dict(m=24, seed=3, precond_rank=16, cg_tol=1e-10)
CASES = {f"{kernel}_{n}": ("binary", dict(n=n, kernel=kernel, **SETTINGS))
         for n in (96, 61) for kernel in ("rbf", "rbf_white")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("classification"))


def _jax_kernel(name):
    spec = ranks.kernel_spec(name)
    k = ops.RBF() if name == "rbf" else ops.RBF() + ops.White()
    return k, jax.tree_util.tree_map(jnp.asarray, spec)


@functools.lru_cache(maxsize=None)
def _jax(P, key):
    kw = CASES[key][1]
    x, y, xt = map(jnp.asarray, ranks.binary_problem(kw["n"], kw["m"], kw["seed"]))
    k, p = _jax_kernel(kw["kernel"])
    mesh = parallel.make_mesh(restart=1, data=P, devices=jax.devices()[:P])
    opts = dict(mesh=mesh, precond_rank=kw["precond_rank"], cg_tol=kw["cg_tol"])
    out = parallel.distributed_fit_predict_binary(k, p, x, y, xt, **opts)
    x_p, _ = parallel.pad_to_multiple(x, P)
    y_p, _ = parallel.pad_to_multiple(y, P)
    fit = parallel.make_distributed_laplace_fit(
        k, n_true=None if x_p.shape[0] == kw["n"] else kw["n"], **opts)
    return [np.asarray(a) for a in out], [np.asarray(a) for a in fit(p, x_p, y_p)]


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_binary_laplace_matches_jax(runs, P, key):
    (prob, pavg, label, mean, var, iters, _, conv), _ = _jax(P, key)
    results = ranks.ok(runs[P][key])
    for res in results:
        np.testing.assert_allclose(res["prob"], prob, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res["pavg"], pavg, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res["mean"], mean, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res["var"], var, rtol=1e-5, atol=1e-8)
        np.testing.assert_array_equal(res["label"], label)
        assert res["iters"] == int(iters)
        assert res["converged"] == bool(conv) and res["converged"]
    for res in results[1:]:  # replicated results: equal bits on every rank
        for name in ("prob", "var", "label"):
            np.testing.assert_array_equal(res[name], results[0][name])


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_laplace_fit_blocks_match_jax(runs, P, key):
    """The fit's row-sharded f, grad and sqrt(W), gathered, against the JAX
    fit's global arrays (the padding included, where W = grad = 0)."""
    n = CASES[key][1]["n"]
    _, (f, grad, sw, iters, _, _) = _jax(P, key)
    for res in ranks.ok(runs[P][key]):
        assert res["rows"] == -(-n // P)
        assert res["fit_iters"] == int(iters)
        np.testing.assert_allclose(res["f"], f, atol=1e-8)
        np.testing.assert_allclose(res["grad"], grad, atol=1e-8)
        np.testing.assert_allclose(res["sqrt_w"], sw, atol=1e-8)
        np.testing.assert_array_equal(res["grad"][n:], 0.0)
        np.testing.assert_array_equal(res["sqrt_w"][n:], 0.0)
