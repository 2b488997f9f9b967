"""Parity of the PyTorch port's kernel algebra (``ops/distance.py``,
``ops/kernels.py``) against the JAX package, in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: rtol 1e-10 (atol 1e-12 for entries that cancel to zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.ops import kernels as jk
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.ops import kernels as tk

BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])
RTOL, ATOL = 1e-10, 1e-12


def _jax_kernels():
    """(name, JAX kernel, JAX params) for every family and combinator."""
    rbf = {"sigma": 1.3, "lengthscale": 0.7}
    per = {"period": 1.7, "lengthscale": 0.9}
    dec = {"amplitude": 1.1, "decay": 2.5, "smoothness": 0.8, "period": 1.3}
    rq = {"amplitude": 0.9, "lengthscale": 1.4, "alpha": 0.6}
    mat = {"sigma": 1.2, "lengthscale": 0.9}
    return [
        ("rbf", jops.RBF(), rbf),
        ("linear", jops.Linear(), {"offset": 0.3}),
        ("periodic", jops.Periodic(), per),
        ("decayed_periodic", jops.DecayedPeriodic(), dec),
        ("rq", jops.RationalQuadratic(), rq),
        ("matern12", jops.Matern(nu=0.5), mat),
        ("matern32", jops.Matern(nu=1.5), mat),
        ("matern52", jops.Matern(nu=2.5), mat),
        ("white", jops.White(), {"amplitude": 0.4}),
        (
            "sum",
            jops.Sum(children=(jops.RBF(), jops.Matern(nu=1.5), jops.White())),
            (rbf, mat, {"amplitude": 0.3}),
        ),
        ("product", jops.RBF() * jops.Periodic(), (rbf, per)),
        ("scaled", jops.Scaled(base=jops.RationalQuadratic()), {"amplitude": 1.7, "base": rq}),
        ("co2", jops.co2_kernel(), jops.co2_params_from_vector(jnp.asarray(BOOK))),
    ]


KERNEL_CASES = _jax_kernels()
KERNEL_IDS = [c[0] for c in KERNEL_CASES]


def _port(jkernel, jparams):
    return convert.kernel_from_reference(jkernel), convert.params_from_numpy(jparams)


def _jparams(jparams):
    return jk.tree_map_params(lambda a: jnp.asarray(a, jnp.float64), jparams)


@pytest.mark.parametrize("method", ["dot", "diff"])
@pytest.mark.parametrize("offset", [0.0, 1980.0])
def test_sqdist_and_absdist_match_jax(rng, method, offset):
    # offset 1980: year-valued inputs, where the centring before the
    # expansion is what keeps float accuracy
    a = offset + rng.uniform(-5, 5, (37, 3))
    b = offset + rng.uniform(-5, 5, (23, 3))
    for fn_j, fn_t in ((jops.sqdist, tops.sqdist), (jops.absdist, tops.absdist)):
        want = np.asarray(fn_j(a, b, method=method))
        got = fn_t(torch.from_numpy(a), torch.from_numpy(b), method=method).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("name,jkernel,jparams", KERNEL_CASES, ids=KERNEL_IDS)
def test_gram_and_diag_match_jax(rng, name, jkernel, jparams):
    x1 = rng.uniform(-5, 5, (41, 2))
    x2 = rng.uniform(-5, 5, (29, 2))
    tkernel, tparams = _port(jkernel, jparams)
    jp = _jparams(jparams)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)

    cross = tops.gram(tkernel, tparams, t1, t2).numpy()
    np.testing.assert_allclose(cross, np.asarray(jops.gram(jkernel, jp, x1, x2)), rtol=RTOL, atol=ATOL)
    same = tops.gram(tkernel, tparams, t1).numpy()
    want = np.asarray(jops.gram(jkernel, jp, x1))
    off = ~np.eye(len(x1), dtype=bool)
    np.testing.assert_allclose(same[off], want[off], rtol=RTOL, atol=ATOL)
    # on the diagonal the expansion cancels to ~1e-15, and kernels reading
    # l2 = sqrt(sq) see sqrt of that rounding (~3e-8) in either package
    np.testing.assert_allclose(np.diag(same), np.diag(want), rtol=RTOL, atol=1e-6)
    diag = tops.gram_diag(tkernel, tparams, t1).numpy()
    np.testing.assert_allclose(diag, np.asarray(jops.gram_diag(jkernel, jp, x1)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,jkernel,jparams", KERNEL_CASES, ids=KERNEL_IDS)
def test_predicates_match_jax(name, jkernel, jparams):
    tkernel, _ = _port(jkernel, jparams)
    assert tk.is_stationary(tkernel) == jk.is_stationary(jkernel)
    assert tk.needs_l2(tkernel) == jk.needs_l2(jkernel)


@pytest.mark.parametrize("name,jkernel,jparams", KERNEL_CASES, ids=KERNEL_IDS)
def test_split_white_matches_jax(rng, name, jkernel, jparams):
    tkernel, tparams = _port(jkernel, jparams)
    jk_nw, jp_nw, jwhite = jk.split_white(jkernel, _jparams(jparams))
    tk_nw, tp_nw, twhite = tk.split_white(tkernel, tparams)
    assert (jwhite is None) == (twhite is None)
    if jwhite is not None:
        np.testing.assert_allclose(float(twhite), float(jwhite), rtol=RTOL)
    assert (jk_nw is None) == (tk_nw is None)
    if jk_nw is not None:
        assert tk_nw == convert.kernel_from_reference(jk_nw)
        x1, x2 = rng.uniform(-5, 5, (17, 2)), rng.uniform(-5, 5, (11, 2))
        np.testing.assert_allclose(
            tops.gram(tk_nw, tp_nw, torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
            np.asarray(jops.gram(jk_nw, jp_nw, x1, x2)),
            rtol=RTOL,
            atol=ATOL,
        )


STATIONARY = [c for c in KERNEL_CASES if jk.is_stationary(c[1])]


@pytest.mark.parametrize("name,jkernel,jparams", STATIONARY, ids=[c[0] for c in STATIONARY])
def test_eval_from_distances_matches_jax(rng, name, jkernel, jparams):
    tkernel, tparams = _port(jkernel, jparams)
    sq = rng.uniform(0, 30, (13, 9))
    want = np.asarray(jk.eval_from_distances(jkernel, _jparams(jparams), jnp.asarray(sq)))
    got = tk.eval_from_distances(tkernel, tparams, torch.from_numpy(sq)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_co2_params_from_vector_matches_jax():
    jp = jops.co2_params_from_vector(jnp.asarray(BOOK))
    tp = tops.co2_params_from_vector(torch.from_numpy(BOOK))
    flat_j = [float(v) for leaf in jp for v in leaf.values()]
    flat_t = [float(v) for leaf in tp for v in leaf.values()]
    assert flat_t == flat_j
    assert convert.kernel_from_reference(jops.co2_kernel()) == tops.co2_kernel()


def test_params_from_numpy_places_and_casts():
    params = ({"sigma": np.float64(1.5), "lengthscale": 2}, {"amplitude": jnp.asarray(0.3)})
    out = convert.params_from_numpy(params, device="cpu", dtype=torch.float32)
    assert isinstance(out, tuple) and set(out[0]) == {"sigma", "lengthscale"}
    for leaf in (out[0]["sigma"], out[0]["lengthscale"], out[1]["amplitude"]):
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    assert float(out[0]["sigma"]) == 1.5


def test_kernel_from_reference_rejects_unknown():
    with pytest.raises(TypeError):
        convert.kernel_from_reference(object())
