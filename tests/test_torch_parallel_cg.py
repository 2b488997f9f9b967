"""The port's distributed CG solvers (``parallel/cg.py``: the ring matvec,
the sharded Nyström, the segmented solve and its resume) against the JAX
package's on a mesh of as many devices, with 1, 2 and 4 gloo ranks, in
float64, including an n that the rank count does not divide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gaussian_process_tpu import gp, ops, parallel
from gaussian_process_tpu.parallel import cg as jax_pcg
from gaussian_process_tpu_torch.parallel import cg as torch_pcg

WORLDS = (1, 2, 4)
ILL = dict(d=1, seed=1, noise=1e-4, tol=1e-9, max_iters=200)
CASES = {
    "mean64": ("mean_cg", dict(n=64, d=3, t=16, seed=0, noise=5e-4, tol=1e-10, max_iters=400)),
    "mean63": ("mean_cg", dict(n=63, d=2, t=9, seed=3, noise=1e-2, tol=1e-12, max_iters=500)),
    "post128": ("posterior_cg", dict(n=128, d=2, t=23, seed=4, noise=1e-2, tol=1e-12,
                                     max_iters=2000)),
    "post61w": ("posterior_cg", dict(n=61, d=2, t=11, seed=5, noise=1e-3, tol=1e-12,
                                     max_iters=2000, kernel="rbf_white")),
    "nystrom": ("posterior_cg", dict(n=256, t=8, preconditioner="nystrom", precond_rank=8,
                                     ill=True, **ILL)),
    "nystrom63": ("posterior_cg", dict(n=63, t=8, preconditioner="nystrom", precond_rank=8,
                                       ill=True, **ILL)),
    "seg_nystrom": ("segmented", dict(n=256, segment_iters=3, preconditioner="nystrom",
                                      precond_rank=8, **ILL)),
    "jacobi63": ("posterior_cg", dict(n=63, t=8, preconditioner="jacobi", ill=True, **ILL)),
    "seg_jacobi63": ("segmented", dict(n=63, segment_iters=4, preconditioner="jacobi",
                                       precond_rank=8, **ILL)),
    "resume": ("resume", dict(stop_after=1, n=256, segment_iters=2, preconditioner="nystrom",
                              precond_rank=8, **dict(ILL, seed=2))),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("cg"))


def _jax_mesh(p):
    return parallel.make_mesh(restart=1, data=p, devices=jax.devices()[:p])


def _same_on_every_rank(results, key):
    for res in results[1:]:
        np.testing.assert_array_equal(res[key], results[0][key])


@pytest.mark.parametrize("key", ["mean64", "mean63"])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_mean_cg_matches_jax(runs, P, key):
    kw = CASES[key][1]
    x, y, xt = map(jnp.asarray, ranks.problem(kw["n"], kw["d"], kw["t"], kw["seed"]))
    k = ops.RBF()
    mean, alpha, iters, _ = parallel.distributed_posterior_mean_cg(
        k, k.init_params(), x, y, xt, mesh=_jax_mesh(P), noise_variance=kw["noise"],
        tol=kw["tol"], max_iters=kw["max_iters"])
    results = ranks.ok(runs[P][key])
    _same_on_every_rank(results, "mean")
    for res in results:
        np.testing.assert_allclose(res["mean"], np.asarray(mean), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res["alpha"], np.asarray(alpha), rtol=1e-6, atol=1e-8)
        assert res["iters"] < kw["max_iters"]


@pytest.mark.parametrize("key", ["post128", "post61w"])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_posterior_cg_matches_jax(runs, P, key):
    kw = CASES[key][1]
    x, y, xt = map(jnp.asarray, ranks.problem(kw["n"], kw["d"], kw["t"], kw["seed"]))
    spec = ranks.kernel_spec(kw.get("kernel", "rbf"))
    k = ops.RBF() if "kernel" not in kw else ops.RBF() + ops.White()
    p = jax.tree_util.tree_map(jnp.asarray, spec)
    mean, var, _, iters, _ = parallel.distributed_posterior_cg(
        k, p, x, y, xt, mesh=_jax_mesh(P), noise_variance=kw["noise"], tol=kw["tol"],
        max_iters=kw["max_iters"])
    dense = gp.posterior(k, p, x, y, xt, noise_variance=kw["noise"])
    results = ranks.ok(runs[P][key])
    _same_on_every_rank(results, "var")
    for res in results:
        np.testing.assert_allclose(res["mean"], np.asarray(mean), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(res["var"], np.asarray(var), rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(res["var"], np.asarray(dense.var), rtol=1e-4, atol=1e-8)


def _ill(n):
    x, y, xt = map(jnp.asarray, ranks.ill_conditioned(n, ILL["d"], ILL["seed"]))
    return ops.RBF(), {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(2.0)}, x, y, xt


@pytest.mark.parametrize("key,n", [("nystrom", 256), ("nystrom63", 63)])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_distributed_nystrom_cg_matches_jax(runs, P, key, n):
    """Same strided landmarks, same Krylov trajectory: the iteration counts
    equal the JAX solver's, and at n = 63 the padded rows stay out of the
    factor."""
    k, p, x, y, xt = _ill(n)
    mean, var, _, iters, _ = jax_pcg.distributed_posterior_cg(
        k, p, x, y, xt, mesh=_jax_mesh(P), noise_variance=ILL["noise"], tol=ILL["tol"],
        max_iters=ILL["max_iters"], preconditioner="nystrom", precond_rank=8)
    for res in ranks.ok(runs[P][key]):
        assert res["iters"] == int(iters)
        np.testing.assert_allclose(res["mean"], np.asarray(mean), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(res["var"], np.asarray(var), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("P", WORLDS)
def test_torch_segmented_nystrom_matches_jax_and_monolithic(runs, P):
    k, p, x, y, xt = _ill(256)
    segs = []
    mean, var, _, iters, _, _ = jax_pcg.distributed_posterior_cg_segmented(
        k, p, x, y, xt, mesh=_jax_mesh(P), noise_variance=ILL["noise"], tol=ILL["tol"],
        max_iters=ILL["max_iters"], segment_iters=3, preconditioner="nystrom",
        precond_rank=8, checkpoint_cb=lambda i, st: segs.append(int(st.iters)))
    mono = ranks.ok(runs[P]["nystrom"])[0]
    for r, res in enumerate(ranks.ok(runs[P]["seg_nystrom"])):
        assert res["segments"] == segs and len(segs) >= 2
        assert res["iters"] == int(iters) == mono["iters"]
        assert res["state_rows"] == 256 // P and res["shard"] == r
        np.testing.assert_allclose(res["mean"], np.asarray(mean), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(res["var"], np.asarray(var), rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(res["mean"], mono["mean"], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("P", WORLDS)
def test_torch_segmented_jacobi_runs_and_equals_monolithic(runs, P):
    """The JAX package's jacobi segments do not run (a scalar against a
    tuple spec); the port's do, at n = 63, and give the monolithic
    solve's bits."""
    mono = ranks.ok(runs[P]["jacobi63"])
    for res, ref in zip(ranks.ok(runs[P]["seg_jacobi63"]), mono):
        assert len(res["segments"]) >= 2
        assert res["iters"] == ref["iters"]
        np.testing.assert_array_equal(res["mean"], ref["mean"])
        np.testing.assert_array_equal(res["var"], ref["var"])
    k, p, x, y, xt = _ill(63)
    jax_mono = jax_pcg.distributed_posterior_cg(
        k, p, x, y, xt, mesh=_jax_mesh(P), noise_variance=ILL["noise"], tol=ILL["tol"],
        max_iters=ILL["max_iters"], preconditioner="jacobi")
    np.testing.assert_allclose(mono[0]["mean"], np.asarray(jax_mono[0]), rtol=1e-6, atol=1e-9)


def test_torch_jax_segmented_jacobi_is_the_reference_fault():
    k, p, x, y, xt = _ill(64)
    with pytest.raises(Exception):
        jax_pcg.distributed_posterior_cg_segmented(
            k, p, x, y, xt, mesh=_jax_mesh(2), noise_variance=ILL["noise"], tol=ILL["tol"],
            max_iters=20, segment_iters=4, preconditioner="jacobi")


@pytest.mark.parametrize("P", WORLDS)
def test_torch_segmented_resume_from_a_checkpoint(runs, P):
    """Stopped after segment 1, saved one file a rank, restored into a
    zeroed state and resumed: equal iterations and bits."""
    for r, res in enumerate(ranks.ok(runs[P]["resume"])):
        assert res["stopped"]
        suffix = f".rank{r}" if r else ""
        assert res["files"] == [f"seg0{suffix}", f"seg1{suffix}"]
        assert 0 < res["restored_iters"] < res["ref_iters"]
        assert res["resumed_iters"] == res["ref_iters"]
        assert res["mean_equal"] and res["var_equal"] and res["alpha_equal"]


@pytest.mark.parametrize("P", WORLDS)
def test_torch_segmented_resume_on_another_problem_raises(runs, P):
    for res in ranks.ok(runs[P]["resume"]):
        wrong_n, wrong_mesh = res["errors"]
        assert "another problem" in wrong_n and "n=248" in wrong_n
        assert "another problem" in wrong_mesh and f"mesh size {P + 1}" in wrong_mesh


def test_torch_landmarks_match_jax():
    for n_eff, rank in [(256, 8), (63, 16), (1000, 64), (5, 16)]:
        np.testing.assert_array_equal(torch_pcg._landmark_global_indices(n_eff, rank),
                                      jax_pcg._landmark_global_indices(n_eff, rank))
