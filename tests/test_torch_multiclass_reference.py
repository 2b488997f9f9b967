"""The port's multi-class Laplace fit (``GPMulticlassClassifier`` on its
matrix-free route) against the benchmark's plain float64 reference
(``gpbench/reference/multiclass.py``): R&W Alg. 3.3 as written, and its
blocked form, which the benchmark runs at n = 102400. CPU, seeded data."""

import math

import pytest
import torch

from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.gp import classification as tcls
from gaussian_process_tpu_torch.gp import multiclass as tmc
from gaussian_process_tpu_torch.models.estimators import (GPBinaryClassifier,
                                                          GPMulticlassClassifier)
from gpbench.reference import multiclass as ref

N, C = 768, 3
PARAMS = {"sigma": 1.0, "lengthscale": 1.0}


def _data(n=N, seed=0, dtype=torch.float64):
    """bench.py's multiclass100k form: uniform on [-3, 3]^2, angle classes."""
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.rand((n, 2), generator=gen, dtype=torch.float64) - 1.0) * 3.0
    angle = torch.atan2(x[:, 1], x[:, 0])
    labels = torch.floor((angle + math.pi) / (2.0 * math.pi) * C).long() % C
    return x.to(dtype), labels


@pytest.fixture(scope="module")
def dense():
    x, labels = _data()
    return ref.dense_fit(x, labels, C, **PARAMS)


def _port(x, labels, **fit):
    model = GPMulticlassClassifier(tops.RBF(), C, dict(PARAMS), device="cpu")
    return model.fit(x, labels, solver="cg", precond_rank=128, **fit)


def test_the_port_in_float64_gives_the_reference_mode_and_probabilities(dense):
    x, labels = _data()
    xs, _ = _data(256, seed=1)
    model = _port(x, labels, cg_tol=1e-10)
    st = model.state
    assert st.converged and dense.converged and dense.iters > 3
    # the port stops at a relative Newton step of 10 sqrt(eps64) = 1.5e-7,
    # after which Newton's quadratic convergence leaves the mode far closer
    # (1.1e-11 read, |f| up to 3.7); CG to 1e-10 adds about 1e-10 of |f|
    assert float(torch.max(torch.abs(st.f_mode - dense.f))) < 1e-9
    p_ref = ref.probabilities(x, labels, dense.pi, xs, **PARAMS, prec=ref.FLOAT64)
    # the probabilities follow the mode through K_s^T (y - pi) (1.4e-11 read)
    assert float(torch.max(torch.abs(model.predict_proba(xs) - p_ref))) < 1e-9


def test_the_port_at_the_cells_settings_in_float32(dense):
    x, labels = _data()
    xs, _ = _data(256, seed=1)
    model = _port(x.float(), labels, cg_tol=1e-4, cg_max_iters=200)
    st = model.state
    assert st.converged and st.f_mode.dtype == torch.float32
    # the port stops at a relative Newton step of 10 sqrt(eps32) = 3.5e-3,
    # each inner solve at 1e-4 of its right-hand side: the mode lies within
    # 1e-3 of |f| <= 3.7 (1.9e-4 read), the probabilities within 1e-3 of
    # their float64 values (7.8e-5 read)
    assert float(torch.max(torch.abs(st.f_mode.double() - dense.f))) < 2e-3
    p_ref = ref.probabilities(x, labels, dense.pi, xs, **PARAMS, prec=ref.FLOAT64)
    assert float(torch.max(torch.abs(model.predict_proba(xs.float()).double() - p_ref))) < 1e-3


def test_the_blocked_reference_equals_the_dense_one(dense):
    x, labels = _data()
    settings = ref.Settings(ref.FLOAT64, 1e-12, 100, 1e-12, 1000, 256, "column", 5)
    blocked = ref.blocked_fit(x, labels, C, **PARAMS, settings=settings)
    assert blocked.converged and blocked.solved
    assert len(blocked.cg_iters) == blocked.iters and max(blocked.cg_iters) < 1000
    # both run the same Newton steps, each to a relative step of 1e-12 and
    # the blocked solves to 1e-12: equal to round-off (3.9e-14 read)
    assert float(torch.max(torch.abs(blocked.f - dense.f))) < 1e-11
    assert torch.allclose(blocked.pi, dense.pi, atol=1e-10, rtol=0)


def test_the_cg_iterations_of_each_newton_step():
    x, labels = _data(256)
    st = _port(x, labels, cg_tol=1e-8).state
    assert len(st.cg_iters) == st.iters > 1
    assert sum(st.cg_iters) == st.inner_iters and min(st.cg_iters) >= 1


def test_a_solve_at_its_cap_shows_in_cg_iters():
    x, labels = _data(256)
    st = _port(x, labels, cg_tol=1e-12, cg_max_iters=1).state
    assert st.cg_iters == (1,) * st.iters and st.inner_iters == st.iters


@pytest.mark.parametrize("estimator, target", [
    (lambda: GPMulticlassClassifier(tops.RBF(), C, dict(PARAMS), device="cpu"),
     (tmc, "laplace_fit_multiclass_cg")),
    (lambda: GPBinaryClassifier(tops.RBF(), dict(PARAMS), device="cpu"),
     (tcls, "laplace_fit_cg"))])
def test_both_estimators_forward_the_cg_options(monkeypatch, estimator, target):
    module, name = target
    seen = []
    original = getattr(module, name)

    def spy(*args, **kw):
        seen.append(kw)
        return original(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    x, labels = _data(128)
    y = labels if module is tmc else (2.0 * (labels == 0).double() - 1.0)
    estimator().fit(x, y, solver="cg", cg_tol=1e-5, cg_max_iters=37)
    estimator().fit(x, y, solver="cg")
    assert [(kw["cg_tol"], kw["cg_max_iters"]) for kw in seen] == [(1e-5, 37), (1e-6, 200)]
    # the Cholesky route runs no CG: it refuses the options before it stores
    # anything, and takes a fit without them
    refused = estimator()
    with pytest.raises(ValueError, match="cg_tol"):
        refused.fit(x, y, solver="cholesky", cg_tol=1e-5)
    with pytest.raises(ValueError, match="cg_max_iters"):
        refused.fit(x, y, solver="auto", cg_max_iters=10)
    assert refused.x_train is None and refused.state is None
    assert refused.fit(x, y, solver="auto").state.converged
