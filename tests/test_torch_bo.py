"""The port's Bayesian optimisation (``opt/bo.py``), ``config.BOConfig``,
``ops.co2_vector_from_params`` and ``ops.co2_kernel``'s keyword against the
JAX package, in float64 on the CPU: twins of tests/test_opt.py's BO tests.

Tolerances: acquisition scores within 1e-12 of the JAX formulas on equal
arrays; the surrogate posterior (the port's unpadded, the JAX package's
padded) within 1e-10; with both packages' candidate draws replaced by the
same NumPy draws, equal picks over 5 iterations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.stats import norm as jnorm

from gaussian_process_tpu import config as jconfig
from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.opt import bo as jbo
from gaussian_process_tpu_torch import config as tconfig
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch import opt as topt
from gaussian_process_tpu_torch.opt import bo as tbo

NOISE = 5e-4
BOUNDS = (np.array([0.01]), np.array([5.0]))


def _data(rng, n=6):
    x = rng.uniform(-5, 5, size=(n, 1))
    y = np.sin(0.9 * x).ravel() + np.sqrt(NOISE) * rng.standard_normal(n)
    return x, y


def _lml_objective(x, y):
    """The port's LML of a unit-sigma RBF as a function of its lengthscale."""
    tx, ty = torch.tensor(x), torch.tensor(y)

    def objective(v):
        p = {"sigma": torch.tensor(1.0, dtype=torch.float64),
             "lengthscale": torch.tensor(float(v[0]), dtype=torch.float64)}
        return float(tgp.log_marginal_likelihood(tops.RBF(), p, tx, ty, noise_variance=NOISE))

    return objective


def test_bo_acquisition_scores_match_jax(rng):
    mean = rng.standard_normal(50)
    std = rng.uniform(0.1, 2.0, 50)
    best = 0.3
    np.testing.assert_allclose(tbo._pi_scores(mean, std, best).numpy(),
                               np.asarray(jnorm.cdf((mean - (best + 5e-4)) / std)),
                               rtol=0, atol=1e-12)
    z = (mean - (best + 5e-4)) / std
    want_ei = (mean - (best + 5e-4)) * jnorm.cdf(z) + std * jnorm.pdf(z)
    np.testing.assert_allclose(tbo._ei_scores(mean, std, best).numpy(), np.asarray(want_ei),
                               rtol=0, atol=1e-12)
    mask = rng.uniform(size=50) > 0.3
    assert topt.acquisition_pi(mean, std, best, mask=mask) == jbo.acquisition_pi(
        jnp.asarray(mean), jnp.asarray(std), best, mask=mask)
    assert topt.acquisition_ei(mean, std, best, mask=mask) == jbo.acquisition_ei(
        jnp.asarray(mean), jnp.asarray(std), best, mask=mask)
    assert topt.acquisition_ucb(mean, std, kappa=0.7, mask=mask) == jbo.acquisition_ucb(
        jnp.asarray(mean), jnp.asarray(std), kappa=0.7, mask=mask)
    assert topt.acquisition_ts(mean, mask=mask) == jbo.acquisition_ts(jnp.asarray(mean),
                                                                      mask=mask)


def test_bo_acquisition_math():
    mean = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    std = torch.ones(3, dtype=torch.float64)
    assert topt.acquisition_ei(mean, std, 0.5) == 2
    assert topt.acquisition_ucb(mean, std, kappa=0.1) == 2
    # PI stops the search when nothing can improve
    assert topt.acquisition_pi(mean, torch.full((3,), 1e-9), best_y=100.0) is None


def test_bo_surrogate_matches_the_jax_padded_surrogate(rng):
    sp = {"sigma": 1.0, "lengthscale": 0.7}
    pts = rng.uniform(-2, 2, size=(5, 2))
    vals = rng.standard_normal(5)
    cands = rng.uniform(-2, 2, size=(9, 2))
    noise = 1e-4
    x_pad = np.repeat(pts[:1], 8, axis=0)
    x_pad[:5] = pts
    y_pad = np.zeros(8)
    y_pad[:5] = vals
    want = jbo._surrogate_posterior_padded(
        jops.RBF(), {k: jnp.asarray(v) for k, v in sp.items()}, jnp.asarray(x_pad),
        jnp.asarray(y_pad), jnp.asarray(5, jnp.int32), jnp.asarray(cands), noise)
    got = tbo._surrogate_posterior(tops.RBF(), sp, pts, vals, cands, noise)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-10)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), atol=1e-10)
    np.testing.assert_allclose(float(got.lml), float(want.lml), rtol=1e-10)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha)[:5], atol=1e-10)


@pytest.mark.parametrize("acq", ["PI", "EI", "UCB"])
def test_bo_picks_equal_jax_on_equal_candidates(rng, monkeypatch, acq):
    """Both packages' candidate draws replaced by the same NumPy draws: the
    searches pick the same points."""
    import jax

    x, y = _data(rng, n=8)

    def jax_objective(v):
        p = {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(float(v[0]))}
        return float(jgp.log_marginal_likelihood(jops.RBF(), p, x, y, noise_variance=NOISE))

    def draws(seed):
        g = np.random.default_rng(seed)
        return lambda _key, bounds, n, d: bounds[0] + g.uniform(size=(n, d)) * (
            bounds[1] - bounds[0])

    monkeypatch.setattr(jbo, "_default_candidates", draws(11))
    monkeypatch.setattr(tbo, "_default_candidates", draws(11))
    init = np.array([[0.3], [4.0]])
    kw = dict(n_iterations=5, n_candidates=60, acquisition=acq, seed=3)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jbo.tune_bayesian_opt(jax_objective, init, BOUNDS, **kw)
    got = topt.tune_bayesian_opt(_lml_objective(x, y), init, BOUNDS, **kw)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-10)
    assert got.stopped_early == want.stopped_early and got.iterations == want.iterations


@pytest.mark.parametrize("acq", ["PI", "EI", "UCB", "TS"])
def test_bo_every_acquisition_improves(rng, acq):
    x, y = _data(rng, n=8)
    objective = _lml_objective(x, y)
    init = np.array([[0.3], [4.0]])
    res = topt.tune_bayesian_opt(objective, init, BOUNDS, n_iterations=4, n_candidates=60,
                                 acquisition=acq, seed=3)
    assert res.best_value >= max(objective(init[0]), objective(init[1])) - 1e-12
    assert res.points.shape[0] >= 2


def test_bo_surrogate_params_fn_co2_style(rng):
    """The CO2 pipeline keys its surrogate on the first evaluated point
    [ref: CO2_example.py:162]."""
    x, y = _data(rng)
    res = topt.tune_bayesian_opt(
        _lml_objective(x, y), np.array([[1.0], [2.0]]), BOUNDS, n_iterations=2,
        n_candidates=30, surrogate_kernel=tops.RBF(),
        surrogate_params_fn=lambda pts: {"sigma": 1.0,
                                         "lengthscale": max(float(pts[0, 0]), 0.1)},
        seed=1,
    )
    assert np.isfinite(res.best_value)


def test_bo_dedup_candidates():
    pts = np.array([[1.0, 2.0], [3.0, 4.0]])
    cands = np.array([[1.0, 2.0], [1.0, 2.1], [5.0, 6.0], [3.0, 4.0]])
    np.testing.assert_array_equal(topt.dedup_candidates(cands, pts), [[1.0, 2.1], [5.0, 6.0]])
    np.testing.assert_array_equal(tbo.fresh_mask(cands, pts), jbo.fresh_mask(cands, pts))


def test_bo_never_evaluates_a_point_twice():
    seen = []

    def objective(v):
        key = tuple(np.round(np.asarray(v, float), 12))
        assert key not in seen, f"evaluated {key} again"
        seen.append(key)
        return -float(((np.asarray(v) - 2.0) ** 2).sum())

    res = topt.tune_bayesian_opt(objective, np.array([[1.0], [3.0]]),
                                 (np.array([0.0]), np.array([5.0])), n_iterations=6,
                                 n_candidates=25, acquisition="EI", seed=0)
    assert len(res.values) == len(seen)


def test_bo_stops_when_the_box_is_exhausted():
    calls = []

    def objective(v):
        calls.append(1)
        return 0.0

    res = topt.tune_bayesian_opt(objective, np.array([[1.0]]),
                                 (np.array([1.0]), np.array([1.0])), n_iterations=5,
                                 n_candidates=10)
    assert res.stopped_early and len(calls) == 1


def test_bo_checkpoint_resume(tmp_path):
    """A second run on the same checkpoint directory continues the stored
    history without evaluating it again, and equals one uninterrupted run."""
    ckdir = str(tmp_path / "bo_ck")
    calls_a, calls_b = [], []

    def make_objective(calls):
        def objective(v):
            calls.append(float(np.asarray(v).ravel()[0]))
            return -float(((np.asarray(v) - 2.0) ** 2).sum())
        return objective

    kw = dict(n_candidates=20, acquisition="EI", seed=3)
    box = (np.array([0.0]), np.array([5.0]))
    res_a = topt.tune_bayesian_opt(make_objective(calls_a), np.array([[1.0]]), box,
                                   n_iterations=3, checkpoint_dir=ckdir, **kw)
    res_b = topt.tune_bayesian_opt(make_objective(calls_b), np.array([[1.0]]), box,
                                   n_iterations=5, checkpoint_dir=ckdir, **kw)
    whole = topt.tune_bayesian_opt(make_objective([]), np.array([[1.0]]), box,
                                   n_iterations=5, **kw)
    assert len(calls_b) <= 2
    np.testing.assert_array_equal(res_b.points[:len(res_a.points)], res_a.points)
    assert res_b.best_value >= res_a.best_value
    np.testing.assert_array_equal(res_b.points, whole.points)


def test_bo_config_matches_jax():
    assert dataclasses.asdict(tconfig.DEFAULT_BO) == dataclasses.asdict(jconfig.DEFAULT_BO)


def test_co2_vector_round_trip():
    theta = torch.tensor([66.0, 67.0, 2.4, 90.0, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19],
                         dtype=torch.float64)
    params = tops.co2_params_from_vector(theta)
    assert torch.equal(tops.co2_vector_from_params(params), theta)
    want = jops.co2_vector_from_params(jops.co2_params_from_vector(jnp.asarray(theta.numpy())))
    np.testing.assert_array_equal(tops.co2_vector_from_params(params).numpy(), np.asarray(want))


def test_co2_kernel_takes_noise_delta_everywhere():
    """Fault (a): the keyword is accepted and ignored, as the JAX function
    does."""
    assert tops.co2_kernel(noise_delta_everywhere=True) == tops.co2_kernel()
    assert tops.co2_kernel(noise_delta_everywhere=False) == tops.co2_kernel()
