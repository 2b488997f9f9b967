"""The port's class-parallel multi-class Laplace (``parallel/multiclass.py``)
against the JAX package's on a mesh of as many devices, with 1, 2 and 4
gloo ranks, in float64, including class counts that the rank count does not
divide (masked dummy classes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gaussian_process_tpu import ops, parallel

WORLDS = (1, 2, 4)
GRID = ((1, 3), (2, 3), (2, 4), (4, 3), (4, 5))
CASES = {f"c{C}": ("multiclass", dict(num_classes=C, seed=C, max_iters=50),
                   tuple(P for P, c in GRID if c == C))
         for C in sorted({c for _, c in GRID})}
CASES["accuracy"] = ("multiclass_accuracy", dict(seed=11, max_iters=50), (4,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("multiclass"))


@pytest.mark.parametrize("P,C", GRID)
def test_torch_sharded_multiclass_matches_jax(runs, P, C):
    x, y = ranks.blobs(C * 8, C, C)
    k = ops.RBF()
    params = {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.0)}
    mesh = parallel.make_mesh(restart=1, data=P, devices=jax.devices()[:P])
    want = parallel.fit_multiclass_sharded(k, params, jnp.asarray(x), jnp.asarray(y), C,
                                           mesh=mesh, max_iters=50)
    results = ranks.ok(runs[P][f"c{C}"])
    for res in results:
        assert res["f_mode"].shape == (C, C * 8)
        np.testing.assert_allclose(res["f_mode"], np.asarray(want.f_mode), atol=1e-8)
        np.testing.assert_allclose(res["pi"], np.asarray(want.pi), atol=1e-8)
        np.testing.assert_allclose(res["lml"], float(want.lml), rtol=1e-8)
        assert res["iters"] == int(want.iters)
        assert res["converged"] == bool(want.converged) and res["converged"]
        trace = np.asarray(want.error_trace)
        np.testing.assert_allclose(res["trace"], trace, rtol=1e-6, atol=1e-12)
        assert np.isnan(res["trace"][res["iters"]:]).all()
    for res in results[1:]:  # replicated results: equal bits on every rank
        assert res["lml"] == results[0]["lml"]
        np.testing.assert_array_equal(res["f_mode"], results[0]["f_mode"])


def test_torch_sharded_multiclass_prediction_accuracy(runs):
    """The fit on 4 ranks feeds the single-card batched prediction and
    classifies held-out blobs essentially perfectly (the reference's
    printed metric [ref: GP_multi_classification.py:253])."""
    for res in ranks.ok(runs[4]["accuracy"]):
        assert res["converged"]
        assert res["accuracy"] >= 0.9
