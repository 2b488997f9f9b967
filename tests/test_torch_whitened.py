"""The port's whitened posterior and LML (``gp/whitened.py``) on the Mauna
Loa CO2 problem at the book hyperparameters, against the JAX package: the
twins of tests/test_whitened.py, on the CPU.

Tolerances, the JAX suite's: in float64 the whitened posterior's mean and
std within 1e-8 of the JAX float64 posterior and its LML within 1e-6; the
fp32 20-year band within 1.0 ppm (mean) and 0.1 ppm (std) of it; the
batched float64 LML within rtol 1e-10 of the serial one and 1e-8 of the
direct LML.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.utils import datasets as jdatasets
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.models import GPRegressor
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops
from gaussian_process_tpu_torch.utils import datasets

THETA_BOOK = np.array([66.0, 67.0, 2.4, 90.0, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])
NOISE = 5e-4


@pytest.fixture(scope="module")
def co2_problem():
    x, y, _ = datasets.mauna_loa()
    xt = datasets.mauna_loa_test_grid(x, years=20)
    oracle = jgp.posterior(jops.co2_kernel(), jops.co2_params_from_vector(jnp.asarray(THETA_BOOK)),
                           jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt),
                           noise_variance=NOISE)
    params = tops.co2_params_from_vector(torch.tensor(THETA_BOOK))
    return tops.co2_kernel(), params, x, y, xt, oracle


def _whitened(co2_problem, dtype):
    k, p, x, y, xt, _ = co2_problem
    return tgp.whitened_posterior(k, p, x, y, xt, noise_variance=NOISE, dtype=dtype,
                                  device="cpu")


def test_whitened_f64_matches_jax_posterior(co2_problem):
    *_, oracle = co2_problem
    w = _whitened(co2_problem, torch.float64)
    np.testing.assert_allclose(w.mean.numpy(), np.asarray(oracle.mean), atol=1e-8)
    np.testing.assert_allclose(w.std.numpy(), np.asarray(oracle.std), atol=1e-8)
    assert abs(w.lml - float(oracle.lml)) < 1e-6


def test_whitened_f64_equals_jax_whitened(co2_problem):
    k, p, x, y, xt, _ = co2_problem
    want = jgp.whitened_posterior(jops.co2_kernel(),
                                  jops.co2_params_from_vector(jnp.asarray(THETA_BOOK)),
                                  x, y, xt, noise_variance=NOISE, dtype=jnp.float64)
    got = _whitened(co2_problem, torch.float64)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-8)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), atol=1e-8)
    assert abs(got.lml - want.lml) < 1e-6
    assert got.y_scale == want.y_scale
    np.testing.assert_array_equal(got.x_shift, want.x_shift)


def test_whitened_lml_f64_matches_jax(co2_problem):
    k, p, x, y, _, oracle = co2_problem
    lml = tgp.whitened_lml(k, p, x, y, noise_variance=NOISE, dtype=torch.float64,
                           device="cpu")
    assert abs(lml - float(oracle.lml)) < 1e-6


def test_whitened_fp32_band_within_the_jax_contract(co2_problem):
    *_, oracle = co2_problem
    w = _whitened(co2_problem, torch.float32)
    assert w.mean.dtype == torch.float32
    dmean = np.max(np.abs(w.mean.double().numpy() - np.asarray(oracle.mean)))
    dstd = np.max(np.abs(w.std.double().numpy() - np.asarray(oracle.std)))
    assert dmean <= 1.0, f"band mean drift {dmean:.3f} ppm > 1.0"
    assert dstd <= 0.1, f"band std drift {dstd:.3f} ppm > 0.1"
    assert float(w.jitter) >= 0.0 and np.isfinite(w.lml)


def test_whitened_and_raw_fp32_both_within_the_band(co2_problem):
    """The twin of the JAX suite's whitened-versus-raw fp32 check. The JAX
    package factors fp32 grams in fp32, where raw year-valued inputs and
    4.4e3-sized entries lose the band, so it asserts that whitening is no
    worse than raw. The port factors fp32 grams in float64, so raw fp32 is
    already well inside the band, and on the CPU whitening does not bring
    it closer: here both must meet the band contract."""
    k, _, x, y, xt, oracle = co2_problem
    w = _whitened(co2_problem, torch.float32)
    p32 = tops.co2_params_from_vector(torch.tensor(THETA_BOOK, dtype=torch.float32))
    raw = tgp.posterior(k, p32, *(torch.tensor(a, dtype=torch.float32) for a in (x, y, xt)),
                        noise_variance=NOISE)
    for post in (w, raw):
        assert np.max(np.abs(post.mean.double().numpy() - np.asarray(oracle.mean))) <= 1.0
        assert np.max(np.abs(post.std.double().numpy() - np.asarray(oracle.std))) <= 0.1


def test_whitened_rejects_nonstationary_kernels(rng):
    x = rng.uniform(-5, 5, (16, 1))
    y = rng.standard_normal(16)
    with pytest.raises(ValueError, match="stationary"):
        tgp.whitened_posterior(tops.Linear(), tops.Linear().init_params(), x, y, x,
                               noise_variance=1e-3, device="cpu")
    with pytest.raises(ValueError, match="stationary"):
        tgp.make_whitened_lml_fn(tops.Linear(), lambda t: {"offset": t[0]}, x, y,
                                 noise_variance=1e-2, device="cpu")


def test_whitened_constant_targets_stay_finite(rng):
    x = rng.uniform(-5, 5, (16, 1))
    w = tgp.whitened_posterior(tops.RBF(), tops.RBF().init_params(), x, np.zeros(16), x,
                               noise_variance=1e-3, dtype=torch.float64, device="cpu")
    assert bool(torch.isfinite(w.mean).all())


def test_whitened_batch_lml_matches_serial_and_direct():
    x, y, _ = datasets.mauna_loa()
    k = tops.co2_kernel()
    thetas = np.stack([THETA_BOOK, THETA_BOOK * 1.1, THETA_BOOK * 0.9])
    batch = tgp.make_whitened_lml_fn(k, tops.co2_params_from_vector, x, y,
                                     noise_variance=NOISE, dtype=torch.float64, chunk=2,
                                     device="cpu")
    got = batch(thetas)
    assert got.shape == (3,) and got.dtype == np.float64
    for i, th in enumerate(thetas):
        serial = tgp.whitened_lml(k, tops.co2_params_from_vector(torch.tensor(th)), x, y,
                                  noise_variance=NOISE, dtype=torch.float64, device="cpu")
        np.testing.assert_allclose(got[i], serial, rtol=1e-10)
    direct = float(jgp.log_marginal_likelihood(
        jops.co2_kernel(), jops.co2_params_from_vector(jnp.asarray(THETA_BOOK)),
        jnp.asarray(x), jnp.asarray(y), noise_variance=NOISE))
    np.testing.assert_allclose(got[0], direct, rtol=1e-8)
    assert batch(THETA_BOOK).shape == (1,)


def test_whitened_batch_retries_a_failing_candidate_alone():
    """A candidate whose factor fails in the batch takes safe_cholesky's
    jitter schedule alone, as the serial LML does."""
    x, y, _ = datasets.mauna_loa()
    x, y = x[:60], y[:60]
    k = tops.RBF()
    to_params = lambda t: {"sigma": t[0], "lengthscale": t[1]}  # noqa: E731
    thetas = np.array([[1.0, 1.0], [30.0, 40.0]])
    got = tgp.make_whitened_lml_fn(k, to_params, x, y, noise_variance=0.0,
                                   dtype=torch.float64, device="cpu")(thetas)
    for i, th in enumerate(thetas):
        serial = tgp.whitened_lml(k, to_params(torch.tensor(th)), x, y, noise_variance=0.0,
                                  dtype=torch.float64, device="cpu")
        np.testing.assert_allclose(got[i], serial, rtol=1e-10)


def test_regressor_posterior_whitened(co2_problem):
    k, p, x, y, xt, _ = co2_problem
    model = GPRegressor(k, p, noise_variance=NOISE, device="cpu").fit(
        torch.tensor(x), torch.tensor(y))
    got = model.posterior_whitened(xt, dtype=torch.float64)
    want = _whitened(co2_problem, torch.float64)
    assert torch.equal(got.mean, want.mean) and got.lml == want.lml


def test_whitened_tree_reaches_the_tile_gram_rule(co2_problem):
    """The whitened CO2 kernel keeps White at the top of the sum, so the
    tile gram (K1) takes it: no nested White, stationary."""
    k, p, *_ = co2_problem
    wk, wp = tgp.whitened.whitened_kernel(k, p, 3.0, dtype=torch.float32, device="cpu")
    assert isinstance(wk, tops.Sum) and isinstance(wk.children[-1], tops.White)
    assert not kops.nested_white(wk) and tops.kernels.is_stationary(wk)
    program, coefs, white_idx = kops.gram_program(wk, wp, True)
    assert white_idx == len(coefs) - 1
    np.testing.assert_allclose(coefs[white_idx].item(), (0.19 / 3.0) ** 2, rtol=1e-6)
    # the same K / s^2 as the JAX package's Scaled over the whole kernel
    xx = torch.tensor(datasets.mauna_loa()[0][:50])
    want = jops.gram(jops.Scaled(base=jops.co2_kernel()),
                     {"amplitude": 1 / 3.0,
                      "base": jops.co2_params_from_vector(jnp.asarray(THETA_BOOK))},
                     jnp.asarray(xx.numpy()))
    wk64, wp64 = tgp.whitened.whitened_kernel(k, p, 3.0, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tops.gram(wk64, wp64, xx).numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_mauna_loa_copy_equals_the_jax_package_data():
    x, y, mean = datasets.mauna_loa()
    jx, jy, jmean = jdatasets.mauna_loa()
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert mean == jmean
