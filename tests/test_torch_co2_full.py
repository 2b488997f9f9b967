"""Reference-scale CO2 Bayesian optimisation on the port (slow tier): the
twin of tests/test_co2_full.py, marked slow as that file is, in float64 on
the CPU. ``chip_smoke.py``'s co2 phase runs the same search on the card
with the whitened float64 LML as the objective.

4 acquisitions x 10 iterations x 500 candidates in the 0.5x-1.5x box
around the book hyperparameters [ref: CO2_example.py:324, :330-379]. EI,
UCB and TS must each reach the book LML's neighbourhood (within 5%), and
the search as a whole must beat it (the JAX suite's bounds).

PI is held to what it does here instead: its unit-RBF surrogate has a prior
mean of 0 and a std of 1 far from the one initial point (LML -384.9), so
every candidate's improvement probability is 1.0, PI takes the first
candidate, and after that one evaluation every probability is 0 and it
stops. Its best is the LML of one uniform draw in the box, which clears
the 5% bound for 51 of the first 100 seeds of this package's candidate
generator (the JAX package's generator clears it at seed 0 by that luck;
``test_port_pi_first_pick_is_a_coin_flip`` counts the seeds). So PI must
stop after exactly that one proposal, at a finite LML.
"""

import numpy as np
import pytest
import torch

from gaussian_process_tpu_torch import gp, ops
from gaussian_process_tpu_torch.opt import tune_bayesian_opt
from gaussian_process_tpu_torch.utils import datasets

pytestmark = pytest.mark.slow

THETA_BOOK = np.array([66.0, 67.0, 2.4, 90.0, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])


def _lml_at():
    x_np, y_np, _ = datasets.mauna_loa()
    x, y = torch.tensor(x_np), torch.tensor(y_np)
    kernel = ops.co2_kernel()

    def lml_at(theta: np.ndarray) -> float:
        params = ops.co2_params_from_vector(torch.tensor(theta, dtype=torch.float64))
        return float(gp.log_marginal_likelihood(kernel, params, x, y, noise_variance=5e-4))

    return lml_at


def test_port_reference_scale_co2_bo():
    lml_at = _lml_at()
    lml_book = lml_at(THETA_BOOK)
    assert np.isfinite(lml_book)
    lo, hi = np.maximum(THETA_BOOK * 0.5, 1e-3), THETA_BOOK * 1.5
    results = {}
    for acq in ("PI", "EI", "UCB", "TS"):
        bo = tune_bayesian_opt(lml_at, initial_points=THETA_BOOK[None, :] + 0.5,
                               bounds=(lo, hi), n_iterations=10, n_candidates=500,
                               acquisition=acq, seed=0)
        results[acq] = bo.best_value
        if acq == "PI":
            assert bo.stopped_early and len(bo.values) == 2 and np.isfinite(bo.best_value)
        else:
            assert bo.best_value > lml_book - 0.05 * abs(lml_book), (acq, bo.best_value,
                                                                     lml_book)
    assert max(results.values()) > lml_book, (results, lml_book)


def test_port_pi_first_pick_is_a_coin_flip():
    """PI's whole search is its first proposal, the first candidate of the
    first draw: over seeds 0-99 that point clears the 5% bound 51 times."""
    from gaussian_process_tpu_torch.opt import bo

    lml_at = _lml_at()
    bound = 0.95 * lml_at(THETA_BOOK)
    lo, hi = np.maximum(THETA_BOOK * 0.5, 1e-3), THETA_BOOK * 1.5
    first = [bo._default_candidates(torch.Generator().manual_seed(seed), (lo, hi), 500,
                                    THETA_BOOK.size)[0] for seed in range(100)]
    assert sum(lml_at(theta) > bound for theta in first) == 51
