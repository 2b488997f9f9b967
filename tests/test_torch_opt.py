"""The port's exact LML training (``opt/gradient.py``, ``GPRegressor.fit(
optimize=True)``) against the JAX package's, in float64 on the CPU.

Same data, same start: the final params agree at rtol 1e-6, the iteration
counts are equal and the LML traces agree at rtol 1e-8. torch.optim's Adam
and SGD apply optax's update rules, so only rounding separates the two
trajectories.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu import opt as jopt
from gaussian_process_tpu.models import GPRegressor as JGPRegressor
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import opt as topt
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.models import GPRegressor as TGPRegressor

NOISE = 5e-4


def _data(rng, n):
    x = rng.uniform(-5, 5, size=(n, 1))
    y = np.sin(0.9 * x).ravel() + np.sqrt(NOISE) * rng.standard_normal(n)
    return x, y


# name: (n, start params, keyword arguments of both tuners)
TUNE_CASES = {
    "sgd_sigma_frozen": (10, {"sigma": 1.0, "lengthscale": 3.0},
                         {"trainable": {"sigma": False, "lengthscale": True}, "max_iters": 2000}),
    "adam_log": (8, {"sigma": 0.5, "lengthscale": 0.1},
                 {"transform": "log", "optimizer": "adam", "learning_rate": 0.05,
                  "max_iters": 500}),
    "sgd_log": (12, {"sigma": 1.5, "lengthscale": 2.0},
                {"transform": "log", "learning_rate": 0.002, "max_iters": 300}),
}


def _by_key(tree):
    return {k: float(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(TUNE_CASES))
def test_tune_gradient_ascent_matches_jax(rng, name):
    n, p0, kwargs = TUNE_CASES[name]
    x, y = _data(rng, n)
    want = jopt.tune_gradient_ascent(
        jops.RBF(), {k: jnp.asarray(v) for k, v in p0.items()}, x, y,
        noise_variance=NOISE, **kwargs)
    got = topt.tune_gradient_ascent(
        tops.RBF(), convert.params_from_numpy(p0, dtype=torch.float64),
        torch.from_numpy(x), torch.from_numpy(y), noise_variance=NOISE, **kwargs)
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    for key, val in _by_key(want.params).items():
        np.testing.assert_allclose(float(got.params[key]), val, rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(got.lml), float(want.lml), rtol=1e-8)
    np.testing.assert_allclose(got.lml_trace.numpy(), np.asarray(want.lml_trace), rtol=1e-8)
    assert not got.params["lengthscale"].requires_grad
    if "trainable" in kwargs:
        assert float(got.params["sigma"]) == 1.0


def test_tuned_lml_rises_and_trace_is_padded(rng):
    x, y = _data(rng, 10)
    p0 = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 3.0}, dtype=torch.float64)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    lml0 = float(tgp.log_marginal_likelihood(tops.RBF(), p0, tx, ty, noise_variance=NOISE))
    res = topt.tune_gradient_ascent(tops.RBF(), p0, tx, ty, noise_variance=NOISE,
                                    max_iters=5000, optimizer="adam", transform="log",
                                    learning_rate=0.05)
    assert float(res.lml) > lml0
    assert res.converged and res.iters < 5000
    assert torch.isfinite(res.lml_trace[: res.iters]).all()
    assert torch.isnan(res.lml_trace[res.iters:]).all()


def test_regressor_fit_optimize_matches_jax_facade(rng):
    x = rng.uniform(-5, 5, (30, 1))
    y = np.sin(0.9 * x).ravel() + 0.05 * rng.standard_normal(30)
    jm = JGPRegressor(jops.RBF()).fit(x, y, optimize=True, max_iters=200)
    tm = TGPRegressor(tops.RBF(), device="cpu").fit(torch.from_numpy(x), torch.from_numpy(y),
                                                     optimize=True, max_iters=200)
    for key, val in _by_key(jm.params).items():
        np.testing.assert_allclose(float(tm.params[key]), val, rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(tm.lml_), float(jm.lml_), rtol=1e-8)
    base = TGPRegressor(tops.RBF(), device="cpu").fit(torch.from_numpy(x), torch.from_numpy(y))
    assert float(tm.lml_) >= float(base.lml_) - 1e-6
    # serving with the tuned params matches the JAX facade and records no graph
    xs = rng.uniform(-5, 5, (7, 1))
    mean, std = tm.predict(torch.from_numpy(xs), return_std=True)
    assert not mean.requires_grad
    jmean, jstd = jm.predict(xs, return_std=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5, atol=1e-8)
    cg = tm.posterior_cg(torch.from_numpy(xs))
    assert not cg.mean.requires_grad


def test_params_to_numpy_round_trip():
    params = (
        {"sigma": torch.tensor(1.5, dtype=torch.float64, requires_grad=True),
         "lengthscale": torch.tensor(0.3, dtype=torch.float64)},
        {"amplitude": torch.tensor(0.2, dtype=torch.float64)},
    )
    back = convert.params_to_numpy(params)
    assert isinstance(back, tuple) and isinstance(back[0]["sigma"], np.ndarray)
    assert float(back[0]["sigma"]) == 1.5 and float(back[1]["amplitude"]) == 0.2
    again = convert.params_from_numpy(back)
    assert float(again[0]["lengthscale"]) == 0.3
    # a JAX function takes the numpy tree
    x = np.linspace(-1, 1, 5)[:, None]
    K = jops.gram(jops.RBF() + jops.White(), back, x)
    np.testing.assert_allclose(
        np.asarray(K),
        tops.gram(tops.RBF() + tops.White(), again, torch.from_numpy(x)).numpy(), rtol=1e-12)


def test_jax_lml_of_port_params_matches(rng):
    """The tuned params carried back to the JAX package give the same LML."""
    x, y = _data(rng, 12)
    res = topt.tune_gradient_ascent(
        tops.RBF(), convert.params_from_numpy({"sigma": 1.2, "lengthscale": 1.0},
                                              dtype=torch.float64),
        torch.from_numpy(x), torch.from_numpy(y), noise_variance=NOISE, max_iters=50,
        optimizer="adam", transform="log", learning_rate=0.05)
    jlml = jgp.log_marginal_likelihood(jops.RBF(), convert.params_to_numpy(res.params), x, y,
                                       noise_variance=NOISE)
    np.testing.assert_allclose(float(res.lml), float(jlml), rtol=1e-10)
