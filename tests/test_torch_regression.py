"""Parity of the port's regression path (``gp/regression.py``,
``models/estimators.py``) against the JAX package, in float64 on the CPU.

Every case builds the JAX kernel and params and carries them over with
``convert.kernel_from_reference`` and ``convert.params_from_numpy``.
Tolerances: the exact posterior at rtol 1e-8 (as tests/test_regression.py
holds it against its oracle); the matrix-free posterior at mean rtol 1e-6
and var rtol 1e-3 (as tests/test_regression.py holds CG against Cholesky).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.models import GPRegressor as JGPRegressor
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.models import GPRegressor as TGPRegressor

NOISE = 5e-4

CASES = {
    "rbf": (jops.RBF(), {"sigma": 1.4, "lengthscale": 2.0}),
    "matern_white": (
        jops.Matern(nu=2.5) + jops.White(),
        ({"sigma": 1.1, "lengthscale": 1.3}, {"amplitude": 0.2}),
    ),
}


def _port(name):
    jkernel, jparams = CASES[name]
    return jkernel, jparams, convert.kernel_from_reference(jkernel), convert.params_from_numpy(jparams)


def _data(rng, n=200, m=50, d=3):
    x = rng.uniform(-5, 5, (n, d))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * rng.standard_normal(n)
    xs = rng.uniform(-5, 5, (m, d))
    return x, y, xs


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_posterior_matches_jax(rng, name):
    jkernel, jparams, tkernel, tparams = _port(name)
    x, y, xs = _data(rng)
    want = jgp.posterior(jkernel, jparams, x, y, xs, noise_variance=NOISE)
    got = tgp.posterior(tkernel, tparams, *_t(x, y, xs), noise_variance=NOISE)
    for field in ("mean", "alpha"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(got.lml), float(want.lml), rtol=1e-8)
    np.testing.assert_allclose(float(got.jitter), float(want.jitter), rtol=1e-12)
    lml = tgp.log_marginal_likelihood(tkernel, tparams, *_t(x, y), noise_variance=NOISE)
    np.testing.assert_allclose(
        float(lml),
        float(jgp.log_marginal_likelihood(jkernel, jparams, x, y, noise_variance=NOISE)),
        rtol=1e-8,
    )


def test_posterior_mean_cg_dense_operator_matches_jax(rng):
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x, y, xs = _data(rng, n=120, m=40, d=2)
    K, Ks = np.asarray(jops.gram(jkernel, jparams, x)), np.asarray(jops.gram(jkernel, jparams, x, xs))
    want, wstate = jgp.posterior_mean_cg(
        lambda v: K @ v, lambda a: Ks.T @ a, jnp.asarray(y), noise_variance=NOISE,
        prior_diag=jops.gram_diag(jkernel, jparams, x), tol=1e-8, max_iters=500,
    )
    tK, tKs = _t(K, Ks)
    got, state = tgp.posterior_mean_cg(
        lambda v: tK @ v, lambda a: tKs.T @ a, torch.from_numpy(y), noise_variance=NOISE,
        prior_diag=tops.gram_diag(tkernel, tparams, torch.from_numpy(x)), tol=1e-8,
        max_iters=500,
    )
    assert 0 < state.iters < 500
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("preconditioner", ["nystrom", "jacobi"])
def test_posterior_cg_matches_jax(rng, name, preconditioner):
    jkernel, jparams, tkernel, tparams = _port(name)
    x, y, xs = _data(rng, n=500, m=21, d=2)  # two chunks, the second ragged
    kw = dict(noise_variance=1e-2, tol=1e-10, test_chunk=16,
              preconditioner=preconditioner, precond_rank=128)
    want = jax.jit(  # jitted: the eager JAX loop spends seconds dispatching
        lambda a, b, c: jgp.posterior_cg(jkernel, jparams, a, b, c, use_pallas=False, **kw)
    )(x, y, xs)
    exact = jgp.posterior(jkernel, jparams, x, y, xs, noise_variance=1e-2)
    # the dense operator (the default on the CPU), then the matrix-free
    # operator through gram_matvec (its plain version on a CPU tensor)
    for use_kernel in (None, True):
        got = tgp.posterior_cg(tkernel, tparams, *_t(x, y, xs), use_kernel=use_kernel, **kw)
        assert got.mean.shape == (21,) and got.var.shape == (21,) and got.iters > 0
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-3, atol=1e-8)
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(exact.mean), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got.var.numpy(), np.asarray(exact.var), rtol=1e-3, atol=1e-8)


def test_posterior_cg_rejects_unknown_preconditioner(rng):
    _, _, tkernel, tparams = _port("rbf")
    x, y, xs = _data(rng, n=20, m=3, d=2)
    with pytest.raises(ValueError):
        tgp.posterior_cg(tkernel, tparams, *_t(x, y, xs), preconditioner="ilu")


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_regressor_facade_matches_jax(rng, solver):
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x, y, xs = _data(rng, n=300, m=40, d=2)
    jm = JGPRegressor(jkernel, jparams, noise_variance=1e-2).fit(x, y)
    tm = TGPRegressor(tkernel, tparams, noise_variance=1e-2, device="cpu").fit(*_t(x, y))
    np.testing.assert_allclose(float(tm.log_marginal_likelihood()),
                               float(jm.log_marginal_likelihood()), rtol=1e-8)
    jmean, jstd = jm.predict(xs, return_std=True, solver=solver)
    tmean, tstd = tm.predict(torch.from_numpy(xs), return_std=True, solver=solver)
    if solver == "cholesky":
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), rtol=1e-8, atol=1e-10)
    else:
        # both facades stop CG at the default relative residual 1e-6, so
        # they agree to about 1e-5 absolute on O(1) outputs
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tm.predict(xs).numpy(), np.asarray(jm.predict(xs)), rtol=1e-8,
                               atol=1e-10)


def test_regressor_facade_refuses_training_and_unfitted_use():
    model = TGPRegressor(tops.RBF())
    with pytest.raises(RuntimeError):
        model.predict(torch.zeros(3, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.fit(torch.zeros(3, 1), torch.zeros(3), optimize=True)


def test_sample_prior_factor_and_covariance(rng):
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x = np.linspace(-5, 5, 40).reshape(-1, 1)
    draws = tgp.sample_prior(tkernel, tparams, torch.from_numpy(x),
                             torch.Generator().manual_seed(7), num_functions=4000,
                             jitter=NOISE, mean=0.5)
    assert draws.shape == (40, 4000)
    # the same normals, through the JAX package's factor
    eps = torch.randn((40, 4000), generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64).numpy()
    K = np.asarray(jops.gram(jkernel, jparams, x))
    from gaussian_process_tpu.linalg import cholesky as jchol

    L = np.asarray(jchol.safe_cholesky(jnp.asarray(K), initial_jitter=NOISE).factor)
    np.testing.assert_allclose(draws.numpy(), 0.5 + L @ eps, rtol=1e-10, atol=1e-10)
    # and the sample covariance against the prior's
    cov = np.cov(draws.numpy())
    assert np.max(np.abs(cov - (K + NOISE * np.eye(40)))) < 0.15
    # the JAX package's own draws share that covariance
    jdraws = np.asarray(jgp.sample_prior(jkernel, jparams, x, jax.random.key(0),
                                         num_functions=4000, jitter=NOISE))
    assert np.max(np.abs(np.cov(jdraws) - cov)) < 0.2


def test_sample_posterior_factor_and_covariance(rng):
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x, y, _ = _data(rng, n=12, m=1, d=1)
    xs = np.linspace(-5, 5, 30).reshape(-1, 1)
    jpost = jgp.posterior(jkernel, jparams, x, y, xs, noise_variance=NOISE)
    tpost = tgp.posterior(tkernel, tparams, *_t(x, y, xs), noise_variance=NOISE)
    draws = tgp.sample_posterior(tkernel, tparams, tpost, torch.from_numpy(xs),
                                 torch.Generator().manual_seed(1), num_functions=3000)
    eps = torch.randn((30, 3000), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64).numpy()
    cov = np.asarray(jops.gram(jkernel, jparams, xs)) - np.asarray(jpost.v).T @ np.asarray(jpost.v)
    from gaussian_process_tpu.linalg import cholesky as jchol

    L = np.asarray(jchol.safe_cholesky(jnp.asarray(cov), initial_jitter=1e-6).factor)
    np.testing.assert_allclose(draws.numpy(), np.asarray(jpost.mean)[:, None] + L @ eps,
                               rtol=1e-7, atol=1e-8)
    emp = np.var(draws.numpy(), axis=1)
    assert np.corrcoef(emp, np.asarray(jpost.var) + 1e-6)[0, 1] > 0.98
    # the facade draws through the same function
    model = TGPRegressor(tkernel, tparams, noise_variance=NOISE).fit(*_t(x, y))
    again = model.sample(torch.from_numpy(xs), torch.Generator().manual_seed(1),
                         num_functions=3000)
    np.testing.assert_allclose(again.numpy(), draws.numpy(), rtol=1e-12, atol=1e-12)
