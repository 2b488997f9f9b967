"""Parity of the port's Laplace classification (``gp/classification.py``,
``gp/multiclass.py``, the classifier facades) against the JAX package, in
float64 on the CPU.

Data are made with numpy from a seed (moons- and blobs-like sets, as the
reference's workloads) and handed to both packages. Tolerances:

- dense fits, same K: modes, factors and LMLs at rtol 1e-9 (one algorithm,
  two linear-algebra libraries); the reference modes at the JAX suite's
  oracle tolerances (rtol 1e-6 on the fixed point);
- predictions on a JAX-fitted state (``convert.*_state_from_numpy``): rtol
  1e-10;
- matrix-free fits and predictions against the JAX ``use_pallas=False``
  paths and against the dense path at ``tests/test_classification.py``'s
  tolerances (binary f and prob rtol 1e-5, var rtol 1e-4; multiclass rtol
  1e-4): both stop their CG solves at a relative residual, not at equality;
- SLQ LML estimates within 2e-2 of the dense LML (a stochastic estimator).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import config as jconfig
from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.models import GPBinaryClassifier as JBinary
from gaussian_process_tpu.models import GPMulticlassClassifier as JMulti
from gaussian_process_tpu_torch import config as tconfig
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.gp import classification as tcls
from gaussian_process_tpu_torch.models import GPBinaryClassifier, GPMulticlassClassifier

import oracles

KERNELS = {
    "rbf": (jops.RBF(), {"sigma": 1.0, "lengthscale": 1.0}),
    "matern_white": (jops.Matern(nu=2.5) + jops.White(),
                     ({"sigma": 1.3, "lengthscale": 0.8}, {"amplitude": 0.2})),
}


def _port(name):
    jkernel, jparams = KERNELS[name]
    return jkernel, jparams, convert.kernel_from_reference(jkernel), convert.params_from_numpy(
        jparams, dtype=torch.float64)


def _split(rng, x, y, test=0.4):
    idx = rng.permutation(len(y))
    k = int(round(len(y) * (1 - test)))
    return x[idx[:k]], x[idx[k:]], y[idx[:k]], y[idx[k:]]


def _moons(seed=0, n=100, noise=0.3):
    """Two interleaved half circles (sklearn's make_moons, made with numpy),
    labels in {-1, +1}, standardised, 60/40 split."""
    rng = np.random.default_rng(seed)
    n_out = n // 2
    t_out = np.linspace(0, np.pi, n_out)
    t_in = np.linspace(0, np.pi, n - n_out)
    x = np.concatenate([np.stack([np.cos(t_out), np.sin(t_out)], 1),
                        np.stack([1 - np.cos(t_in), 1 - np.sin(t_in) - 0.5], 1)])
    x = x + noise * rng.standard_normal(x.shape)
    y = np.concatenate([-np.ones(n_out), np.ones(n - n_out)])
    x = (x - x.mean(0)) / x.std(0)
    return _split(rng, x, y)


def _blobs(seed=7, n=100, centers=3, std=1.0):
    """Gaussian blobs around centres drawn in [-10, 10]^2 (sklearn's
    make_blobs, made with numpy), integer labels, 60/40 split."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (centers, 2))
    y = np.arange(n) % centers
    x = c[y] + std * rng.standard_normal((n, 2))
    return _split(rng, x, y)


def _binary_problem(rng, n=500, m=80):
    x = rng.uniform(-3, 3, (n, 2))
    y = np.where(np.sin(x.sum(axis=1)) + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return x, y, rng.uniform(-3, 3, (m, 2))


def _multi_problem(rng, n=300, m=60, C=3):
    x = rng.uniform(-3, 3, (n, 2))
    ang = np.arctan2(x[:, 1], x[:, 0])
    y = ((ang + np.pi) / (2 * np.pi) * C).astype(int) % C
    return x, y, rng.uniform(-3, 3, (m, 2)), C


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ binary, dense


@pytest.mark.parametrize("mode", ["newton", "reference"])
def test_binary_laplace_fit_matches_jax(rng, mode):
    x, _, y, _ = _moons()
    K = oracles.rbf(x, x, 1.0, 1.0)
    kw = {}
    if mode == "reference":
        kw = dict(f_init=rng.standard_normal(len(y)), max_iters=10000)
    want = jgp.laplace_fit(jnp.asarray(K), jnp.asarray(y), mode=mode, **kw)
    got = tgp.laplace_fit(torch.from_numpy(K), torch.from_numpy(y), mode=mode,
                          **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    assert got.iters == int(want.iters) and got.converged == bool(want.converged)
    assert got.converged
    rtol = 1e-9 if mode == "newton" else 1e-6
    for field in ("f_mode", "grad_at_mode", "sqrt_w", "chol_B"):
        _close(getattr(got, field), getattr(want, field), rtol=rtol, atol=1e-12)
    _close(float(got.lml), float(want.lml), rtol=rtol)
    assert got.error_trace.shape == want.error_trace.shape
    _close(got.error_trace[:got.iters], want.error_trace[:got.iters], rtol=1e-6, atol=1e-12)
    assert bool(torch.isnan(got.error_trace[got.iters:]).all())


def test_binary_oracle_mode_and_stationarity():
    """Against the float64 NumPy oracle, and f = K (t - pi(f)) at the mode."""
    x, _, y, _ = _moons()
    K = oracles.rbf(x, x, 1.0, 1.0)
    f_o, _, _, sW, _ = oracles.laplace_binary_mode(K, y)
    st = tgp.laplace_fit(torch.from_numpy(K), torch.from_numpy(y))
    _close(st.f_mode, f_o, rtol=1e-6, atol=1e-8)
    _close(st.sqrt_w, sW, rtol=1e-6, atol=1e-8)
    _close(st.f_mode, K @ st.grad_at_mode.numpy(), rtol=1e-5, atol=1e-6)
    assert st.iters < 30  # true Newton, not the reference's thousands


def test_binary_config_and_mode_checks():
    x, _, y, _ = _moons()
    K, yt = torch.from_numpy(oracles.rbf(x, x, 1.0, 1.0)), torch.from_numpy(y)
    cfg = tconfig.NewtonConfig(tol=1e-2, max_iters=2)
    got = tgp.laplace_fit(K, yt, cfg=cfg)
    want = jgp.laplace_fit(jnp.asarray(K.numpy()), jnp.asarray(y),
                           cfg=jconfig.NewtonConfig(tol=1e-2, max_iters=2))
    assert got.iters == int(want.iters) <= 2
    _close(got.f_mode, want.f_mode, rtol=1e-9, atol=1e-12)
    assert tconfig.DEFAULT_NEWTON.__dict__ == jconfig.DEFAULT_NEWTON.__dict__
    with pytest.raises(ValueError, match="mode"):
        tgp.laplace_fit(K, yt, mode="damped")


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_binary_fit_predict_matches_jax(name):
    jkernel, jparams, tkernel, tparams = _port(name)
    xtr, xte, ytr, _ = _moons(seed=1)
    jst = jgp.fit_binary(jkernel, jparams, xtr, jnp.asarray(ytr))
    jpred = jgp.predict_binary(jkernel, jparams, jst, xtr, xte)
    st = tgp.fit_binary(tkernel, tparams, *_t(xtr, ytr))
    pred = tgp.predict_binary(tkernel, tparams, st, *_t(xtr, xte))
    assert st.iters == int(jst.iters)
    _close(st.f_mode, jst.f_mode, rtol=1e-9, atol=1e-12)
    for field in ("mean", "var", "prob", "prob_averaged", "label"):
        _close(getattr(pred, field), getattr(jpred, field), rtol=1e-9, atol=1e-12)
    # and the port's predict on the JAX package's own mode
    on_jax = tcls.laplace_predict(convert.binary_state_from_numpy(jst),
                                  tops.gram(tkernel, tparams, *_t(xtr, xte)),
                                  tops.gram_diag(tkernel, tparams, torch.from_numpy(xte)))
    for field in ("mean", "var", "prob", "label"):
        _close(getattr(on_jax, field), getattr(jpred, field), rtol=1e-10, atol=1e-13)


def test_binary_moons_accuracy_and_reference_mode():
    """The reference's metric [ref: GP_binary_classification.py:241]: true
    Newton is solid on moons, and at least as good as the frozen-W
    reference mode started from a prior sample."""
    xtr, xte, ytr, yte = _moons(n=200)
    k = tops.RBF()
    p = convert.params_from_numpy(k.init_params())
    st = tgp.fit_binary(k, p, *_t(xtr, ytr))
    acc = float(np.mean(tgp.predict_binary(k, p, st, *_t(xtr, xte)).label.numpy() == yte))
    f_prior = torch.from_numpy(np.random.default_rng(3).standard_normal(len(ytr)))
    ref = tgp.fit_binary(k, p, *_t(xtr, ytr), f_init=f_prior, mode="reference",
                         max_iters=10000)
    acc_ref = float(np.mean(tgp.predict_binary(k, p, ref, *_t(xtr, xte)).label.numpy() == yte))
    assert acc >= 0.85 and acc >= acc_ref - 1e-9


# -------------------------------------------------------- multiclass, dense


@pytest.mark.parametrize("mode", ["newton", "reference"])
def test_multiclass_laplace_fit_matches_jax(mode):
    x, _, y, _ = _blobs()
    n = 60 if mode == "newton" else 21  # the reference mode's dense (Cn)^2 loop
    x, y = x[:n], y[:n]
    C = 3
    Kc = oracles.rbf(x, x, 1.0, 1.0)
    Y = np.eye(C)[:, y]
    kw = dict(tol=1e-10) if mode == "newton" else dict(max_iters=3000)
    want = jgp.laplace_fit_multiclass(jnp.broadcast_to(jnp.asarray(Kc), (C, n, n)),
                                      jnp.asarray(Y), mode=mode, **kw)
    got = tgp.laplace_fit_multiclass(torch.from_numpy(Kc).expand(C, n, n),
                                     torch.from_numpy(Y), mode=mode, **kw)
    assert got.iters == int(want.iters) and got.converged == bool(want.converged)
    rtol = 1e-9 if mode == "newton" else 1e-6
    _close(got.f_mode, want.f_mode, rtol=rtol, atol=1e-10)
    _close(got.pi, want.pi, rtol=rtol, atol=1e-10)
    if mode == "newton":
        _close(float(got.lml), float(want.lml), rtol=1e-9)
        # stationarity: f_c = K (y_c - pi_c)
        _close(got.f_mode, (Y - got.pi.numpy()) @ Kc.T, rtol=1e-6, atol=1e-7)
    else:
        assert bool(torch.isnan(got.lml))


def test_multiclass_fit_predict_matches_jax():
    jkernel, jparams, tkernel, tparams = _port("rbf")
    xtr, xte, ytr, yte = _blobs()
    jst = jgp.fit_multiclass(jkernel, jparams, xtr, jnp.asarray(ytr), 3)
    jpred = jgp.predict_multiclass(jkernel, jparams, jst, xtr, jnp.asarray(ytr), xte, 3)
    st = tgp.fit_multiclass(tkernel, tparams, *_t(xtr, ytr), 3)
    pred = tgp.predict_multiclass(tkernel, tparams, st, *_t(xtr, ytr, xte), 3)
    assert st.iters == int(jst.iters)
    for field in ("mean", "prob", "label"):
        _close(getattr(pred, field), getattr(jpred, field), rtol=1e-9, atol=1e-12)
    _close(pred.prob.sum(0), np.ones(len(xte)), rtol=1e-12)
    assert float(np.mean(pred.label.numpy() == yte)) >= 0.9
    # the port's predict on the JAX package's own mode
    y1 = tgp.one_hot_targets(torch.from_numpy(ytr), 3, dtype=torch.float64)
    Ks = tops.gram(tkernel, tparams, *_t(xtr, xte))
    on_jax = tgp.laplace_predict_multiclass(convert.multiclass_state_from_numpy(jst), y1,
                                            Ks.expand(3, *Ks.shape))
    for field in ("mean", "prob", "label"):
        _close(getattr(on_jax, field), getattr(jpred, field), rtol=1e-10, atol=1e-13)


def test_multiclass_dense_lml_matches_stacked_f64_oracle(rng):
    """The corrected R&W 3.44 logdet: sum_c log|B_c| + log|sum_c E_c| must
    equal the brute-force stacked-system value."""
    x, y, _, C = _multi_problem(rng, n=120, m=8)
    k = tops.RBF()
    p = convert.params_from_numpy(k.init_params())
    dense = tgp.fit_multiclass(k, p, *_t(x, y), C)
    K = oracles.rbf(x, x, 1.0, 1.0)
    pi, f = dense.pi.numpy(), dense.f_mode.numpy()
    n, N = len(y), C * len(y)
    W, Kf = np.zeros((N, N)), np.zeros((N, N))
    for i in range(n):
        Wi = np.diag(pi[:, i]) - np.outer(pi[:, i], pi[:, i])
        for c in range(C):
            W[c * n + i, np.arange(C) * n + i] = Wi[c]
    for c in range(C):
        Kf[c * n:(c + 1) * n, c * n:(c + 1) * n] = K
    fv = f.reshape(N)
    want = (-0.5 * fv @ np.linalg.solve(Kf, fv) + np.eye(C)[:, y].reshape(N) @ fv
            - np.sum(np.log(np.sum(np.exp(f), axis=0)))
            - 0.5 * np.linalg.slogdet(np.eye(N) + W @ Kf)[1])
    _close(float(dense.lml), want, rtol=1e-8)


def test_multiclass_any_n_and_one_hot():
    x, _, y, _ = _blobs(seed=3, n=47)
    k = tops.RBF()
    st = tgp.fit_multiclass(k, convert.params_from_numpy(k.init_params()), *_t(x, y), 3)
    assert st.f_mode.shape == (3, len(y)) and bool(torch.isfinite(st.f_mode).all())
    _close(st.pi.sum(0), np.ones(len(y)), rtol=1e-10)
    _close(tgp.one_hot_targets(torch.tensor([2, 0, 1]), 3, dtype=torch.float64),
           np.asarray(jgp.one_hot_targets(jnp.asarray([2, 0, 1]), 3)), rtol=0)


# ------------------------------------------------------ binary, matrix-free


def _jax_cg_binary(jkernel, jparams, x, y, xt, rank, **kw):
    st = jgp.laplace_fit_cg(jkernel, jparams, jnp.asarray(x), jnp.asarray(y),
                            precond_rank=rank, use_pallas=False, **kw)
    return st, jgp.predict_binary_cg(jkernel, jparams, st, jnp.asarray(x), jnp.asarray(xt),
                                     use_pallas=False)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_binary_cg_matches_jax_and_dense(rng, use_kernel):
    """``use_kernel=None`` is the dense operator on the CPU, ``True`` the
    matrix-free ``gram_matvec`` (its plain sweep on a CPU tensor)."""
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x, y, xt = _binary_problem(rng)
    jst, jpred = _jax_cg_binary(jkernel, jparams, x, y, xt, 64)
    dense = tgp.fit_binary(tkernel, tparams, *_t(x, y))
    dpred = tgp.predict_binary(tkernel, tparams, dense, *_t(x, xt))
    st = tgp.laplace_fit_cg(tkernel, tparams, *_t(x, y), precond_rank=64,
                            use_kernel=use_kernel)
    pred = tgp.predict_binary_cg(tkernel, tparams, st, *_t(x, xt), use_kernel=use_kernel,
                                 test_chunk=32)  # three chunks, the last ragged
    assert st.converged and st.iters == int(jst.iters) == dense.iters
    assert st.inner_iters > 0 and st.U.dtype == torch.float64
    for ref_st, ref_pred in ((jst, jpred), (dense, dpred)):
        _close(st.f_mode, ref_st.f_mode, rtol=1e-5, atol=1e-6)
        _close(pred.prob, ref_pred.prob, rtol=1e-5, atol=1e-6)
        _close(pred.var, ref_pred.var, rtol=1e-4, atol=1e-7)
        assert np.array_equal(pred.label.numpy(), np.asarray(ref_pred.label))
    # the port's matrix-free predict on the JAX package's own CG state
    on_jax = tgp.predict_binary_cg(tkernel, tparams, convert.binary_state_from_numpy(jst),
                                   *_t(x, xt))
    _close(on_jax.prob, jpred.prob, rtol=1e-7, atol=1e-9)
    _close(on_jax.var, jpred.var, rtol=1e-4, atol=1e-7)


def test_binary_cg_warm_start_resumes(rng):
    _, _, tkernel, tparams = _port("rbf")
    x, y, _ = _binary_problem(rng, n=300)
    st1 = tgp.laplace_fit_cg(tkernel, tparams, *_t(x, y), precond_rank=48)
    st2 = tgp.laplace_fit_cg(tkernel, tparams, *_t(x, y), precond_rank=48, f_init=st1.f_mode)
    assert st2.iters <= 2
    _close(st2.f_mode, st1.f_mode, rtol=1e-6, atol=1e-8)


def test_binary_cg_moons_accuracy_matches_dense():
    xtr, xte, ytr, yte = _moons(seed=0, n=240, noise=0.25)
    _, _, tkernel, tparams = _port("rbf")
    dense = tgp.predict_binary(tkernel, tparams, tgp.fit_binary(tkernel, tparams,
                                                                *_t(xtr, ytr)), *_t(xtr, xte))
    st = tgp.laplace_fit_cg(tkernel, tparams, *_t(xtr, ytr), precond_rank=48)
    cg = tgp.predict_binary_cg(tkernel, tparams, st, *_t(xtr, xte))
    acc_d = float(np.mean(dense.label.numpy() == yte))
    acc_c = float(np.mean(cg.label.numpy() == yte))
    assert acc_c == acc_d and acc_c > 0.85


# -------------------------------------------------- multiclass, matrix-free


@pytest.mark.parametrize("use_kernel", [None, True])
def test_multiclass_cg_matches_jax_and_dense(rng, use_kernel):
    jkernel, jparams, tkernel, tparams = _port("rbf")
    x, y, xt, C = _multi_problem(rng)
    jst = jgp.laplace_fit_multiclass_cg(jkernel, jparams, jnp.asarray(x), jnp.asarray(y), C,
                                        precond_rank=64, use_pallas=False)
    jpred = jgp.predict_multiclass_cg(jkernel, jparams, jst, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(xt), C)
    dense = tgp.fit_multiclass(tkernel, tparams, *_t(x, y), C)
    dpred = tgp.predict_multiclass(tkernel, tparams, dense, *_t(x, y, xt), C)
    st = tgp.laplace_fit_multiclass_cg(tkernel, tparams, *_t(x, y), C, precond_rank=64,
                                       use_kernel=use_kernel)
    pred = tgp.predict_multiclass_cg(tkernel, tparams, st, *_t(x, y, xt), C, test_chunk=25)
    assert st.converged and st.iters == int(jst.iters) == dense.iters
    for ref_st, ref_pred in ((jst, jpred), (dense, dpred)):
        _close(st.f_mode, ref_st.f_mode, rtol=1e-4, atol=1e-5)
        _close(pred.prob, ref_pred.prob, rtol=1e-4, atol=1e-5)
        assert np.array_equal(pred.label.numpy(), np.asarray(ref_pred.label))
    on_jax = tgp.predict_multiclass_cg(tkernel, tparams,
                                       convert.multiclass_state_from_numpy(jst),
                                       *_t(x, y, xt), C)
    _close(on_jax.prob, jpred.prob, rtol=1e-10, atol=1e-13)


def test_multiclass_cg_blobs_accuracy_matches_dense():
    xtr, xte, ytr, yte = _blobs(seed=0, n=180, std=1.2)
    xtr, xte = (xtr - xtr.mean(0)) / xtr.std(0), (xte - xtr.mean(0)) / xtr.std(0)
    _, _, tkernel, tparams = _port("rbf")
    dense = tgp.fit_multiclass(tkernel, tparams, *_t(xtr, ytr), 3)
    dpred = tgp.predict_multiclass(tkernel, tparams, dense, *_t(xtr, ytr, xte), 3)
    st = tgp.laplace_fit_multiclass_cg(tkernel, tparams, *_t(xtr, ytr), 3, precond_rank=48)
    cpred = tgp.predict_multiclass_cg(tkernel, tparams, st, *_t(xtr, ytr, xte), 3)
    acc_d = float(np.mean(dpred.label.numpy() == yte))
    acc_c = float(np.mean(cpred.label.numpy() == yte))
    assert acc_c == acc_d and acc_c > 0.85


# ------------------------------------------ both matrix-free fits: LML, 1-D


def _fit_cg(kind, tkernel, tparams, x, y, **kw):
    if kind == "binary":
        return tgp.laplace_fit_cg(tkernel, tparams, x, y, **kw)
    return tgp.laplace_fit_multiclass_cg(tkernel, tparams, x, y, 3, **kw)


def _labels(kind, x):
    if kind == "binary":
        return np.where(np.sin(1.5 * x[:, 0]) - x[:, 1] > 0, 1.0, -1.0)
    return ((np.arctan2(x[:, 1], x[:, 0]) + np.pi) / (2 * np.pi) * 3).astype(int) % 3


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_cg_slq_lml_close_to_dense(rng, kind):
    _, _, tkernel, tparams = _port("rbf")
    x = rng.uniform(-3, 3, (240, 2))
    y = _labels(kind, x)
    dense = (tgp.fit_binary(tkernel, tparams, *_t(x, y)) if kind == "binary"
             else tgp.fit_multiclass(tkernel, tparams, *_t(x, y), 3))
    st = _fit_cg(kind, tkernel, tparams, *_t(x, y), precond_rank=64, compute_lml=True,
                 lml_probes=16, lml_generator=torch.Generator().manual_seed(1))
    # 16 Rademacher probes put the logdet's standard error near 1%
    assert abs(float(st.lml) - float(dense.lml)) < 2e-2 * abs(float(dense.lml))


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_cg_lml_runs_no_extra_newton_step(rng, monkeypatch, kind):
    """``compute_lml`` takes a = K^-1 f from the last Newton step: it adds
    exactly the SLQ's probes x Lanczos steps kernel matvecs, where rerunning
    a Newton step (the JAX package's way) would add two more plus a solve."""
    _, _, tkernel, tparams = _port("rbf")
    x = rng.uniform(-3, 3, (150, 2))
    y = _labels(kind, x)
    calls = [0]
    plain = tcls._kops.gram_matvec

    def counting(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tcls._kops, "gram_matvec", counting)
    counts, states = [], []
    for lml in (False, True):
        calls[0] = 0
        states.append(_fit_cg(kind, tkernel, tparams, *_t(x, y), precond_rank=32,
                              use_kernel=True, compute_lml=lml, lml_probes=3,
                              lml_lanczos_iters=5))
        counts.append(calls[0])
    assert counts[1] - counts[0] == 3 * 5
    _close(states[1].f_mode, states[0].f_mode, rtol=0, atol=0)
    assert bool(torch.isnan(states[0].lml)) and bool(torch.isfinite(states[1].lml))


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_cg_one_dimensional_inputs_are_points(rng, kind):
    """Inputs of shape (n,) are n points of dimension 1, as (n, 1) (the JAX
    package's ``jnp.atleast_2d`` would make them one point of dimension n)."""
    _, _, tkernel, tparams = _port("rbf")
    x = rng.uniform(-3, 3, 120)
    y = (np.where(np.sin(2 * x) > 0, 1.0, -1.0) if kind == "binary"
         else (np.floor((x + 3) / 2)).astype(int) % 3)
    xt = rng.uniform(-3, 3, 9)
    outs = []
    for shape in ((-1,), (-1, 1)):
        xx, xxt = torch.from_numpy(x.reshape(shape)), torch.from_numpy(xt.reshape(shape))
        st = _fit_cg(kind, tkernel, tparams, xx, torch.from_numpy(y), precond_rank=16)
        pred = (tgp.predict_binary_cg(tkernel, tparams, st, xx, xxt) if kind == "binary"
                else tgp.predict_multiclass_cg(tkernel, tparams, st, xx, torch.from_numpy(y),
                                               xxt, 3))
        assert st.f_mode.shape[-1] == 120 and pred.prob.shape[-1] == 9
        outs.append(pred.prob)
    _close(outs[0], outs[1], rtol=0, atol=0)


# ------------------------------------------------------------------ facades


def test_binary_classifier_moons():
    xtr, xte, ytr, yte = _moons(seed=0)
    model = GPBinaryClassifier(tops.RBF(), device="cpu").fit(*_t(xtr, ytr))
    assert model.score(torch.from_numpy(xte), torch.from_numpy(yte)) >= 0.8
    proba = model.predict_proba(torch.from_numpy(xte))
    assert bool(((proba >= 0) & (proba <= 1)).all())
    labels = GPBinaryClassifier(tops.RBF(), device="cpu").fit(
        *_t(*_moons(seed=1)[::2])).predict(torch.from_numpy(xte))
    assert set(np.unique(labels.numpy())) <= {-1.0, 1.0}


def test_multiclass_classifier_blobs():
    xtr, xte, ytr, yte = _blobs(seed=0)
    model = GPMulticlassClassifier(tops.RBF(), num_classes=3, device="cpu").fit(*_t(xtr, ytr))
    assert model.score(torch.from_numpy(xte), torch.from_numpy(yte)) >= 0.8
    _close(model.predict_proba(torch.from_numpy(xte)).sum(0), np.ones(len(xte)), rtol=1e-5)


@pytest.mark.parametrize("cls", [GPBinaryClassifier, GPMulticlassClassifier])
def test_classifier_refuses_unfitted_use_and_unknown_solver(rng, cls):
    model = cls(tops.RBF()) if cls is GPBinaryClassifier else cls(tops.RBF(), 3)
    with pytest.raises(RuntimeError):
        model.predict(torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="solver"):
        model.fit(torch.from_numpy(rng.uniform(-3, 3, (20, 2))), torch.ones(20), solver="qr")


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_classifier_cg_solver_matches_cholesky(rng, kind):
    """TestClassifierCGSolver's twin: the matrix-free facade reproduces the
    dense one's labels and probabilities."""
    x = rng.uniform(-3, 3, (240 if kind == "binary" else 210, 2))
    y = _labels(kind, x)
    xt = torch.from_numpy(rng.uniform(-3, 3, (60, 2)))
    make = (lambda: GPBinaryClassifier(tops.RBF(), device="cpu")) if kind == "binary" else (
        lambda: GPMulticlassClassifier(tops.RBF(), 3, device="cpu"))
    a = make().fit(*_t(x, y), solver="cholesky")
    b = make().fit(*_t(x, y), solver="cg", precond_rank=48)
    assert b._solver == "cg" and make().fit(*_t(x, y))._solver == "cholesky"  # auto
    np.testing.assert_array_equal(a.predict(xt).numpy(), b.predict(xt).numpy())
    _close(a.predict_proba(xt), b.predict_proba(xt), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_classifier_facade_matches_jax(rng, kind, solver):
    x = rng.uniform(-3, 3, (200, 2))
    y = _labels(kind, x)
    xt = rng.uniform(-3, 3, (40, 2))
    if kind == "binary":
        jm = JBinary(jops.RBF()).fit(x, y, solver=solver, precond_rank=48)
        tm = GPBinaryClassifier(tops.RBF(), device="cpu").fit(*_t(x, y), solver=solver,
                                                             precond_rank=48)
    else:
        jm = JMulti(jops.RBF(), 3).fit(x, y, solver=solver, precond_rank=48)
        tm = GPMulticlassClassifier(tops.RBF(), 3, device="cpu").fit(*_t(x, y), solver=solver,
                                                                     precond_rank=48)
    rtol = 1e-9 if solver == "cholesky" else 1e-5
    _close(tm.predict_proba(torch.from_numpy(xt)), jm.predict_proba(xt), rtol=rtol, atol=1e-7)
    np.testing.assert_array_equal(tm.predict(torch.from_numpy(xt)).numpy(),
                                  np.asarray(jm.predict(xt)))
    assert tm.score(torch.from_numpy(xt), torch.from_numpy(np.array(jm.predict(xt)))) == 1.0


def test_w_sqrt_blocks_batches_the_eigh(rng, monkeypatch):
    """The per-point W roots come out the same whether the batched eigh
    runs whole or in batches (cuSOLVER refuses large batches), and square
    to the W blocks."""
    from gaussian_process_tpu_torch.gp import multiclass as tmc

    pi = torch.softmax(torch.from_numpy(rng.standard_normal((3, 1000))), dim=0)
    whole = tmc._w_sqrt_blocks(pi)
    monkeypatch.setattr(tmc, "EIGH_BATCH", 96)
    batched = tmc._w_sqrt_blocks(pi)
    _close(batched, whole, rtol=0, atol=1e-14)
    _close(batched @ batched, tmc._w_blocks(pi), rtol=0, atol=1e-12)


def _multiclass_full_newton_oracle(K_block, Y, max_iters=100, tol=1e-10):
    """Dense (Cn x Cn) Newton on the stacked system with an explicit
    W = D - PI PI^T (the JAX suite's ground truth for the blocked path)."""
    C, n = Y.shape
    Kfull = np.kron(np.eye(C), K_block)
    f, y = np.zeros(C * n), Y.reshape(-1)
    for _ in range(max_iters):
        F = f.reshape(C, n)
        P = np.exp(F - F.max(0)) / np.exp(F - F.max(0)).sum(0)
        Pi = np.concatenate([np.diag(P[c]) for c in range(C)])
        W = np.diag(P.reshape(-1)) - Pi @ Pi.T
        f_new = Kfull @ np.linalg.solve(np.eye(C * n) + W @ Kfull, W @ f + y - P.reshape(-1))
        done = np.linalg.norm(f_new - f) < tol
        f = f_new
        if done:
            break
    F = f.reshape(C, n)
    return F, np.exp(F - F.max(0)) / np.exp(F - F.max(0)).sum(0)


@pytest.mark.parametrize("case", ["binary_predict", "binary_reference", "multiclass_newton"])
def test_port_matches_numpy_oracles(rng, case):
    """The float64 NumPy oracles of ``tests/oracles.py`` (the JAX suite's
    ground truth), at its tolerances."""
    if case == "multiclass_newton":
        x, _, y, _ = _blobs()
        x, y = x[:30], y[:30]  # keeps the dense (Cn)^2 oracle small
        K = oracles.rbf(x, x, 1.0, 1.0)
        F_o, P_o = _multiclass_full_newton_oracle(K, np.eye(3)[:, y])
        st = tgp.laplace_fit_multiclass(torch.from_numpy(K).expand(3, 30, 30),
                                        torch.from_numpy(np.eye(3)[:, y]), tol=1e-10)
        assert st.converged
        _close(st.f_mode, F_o, rtol=1e-5, atol=1e-7)
        _close(st.pi, P_o, rtol=1e-5, atol=1e-7)
        return
    xtr, xte, ytr, _ = _moons()
    K = oracles.rbf(xtr, xtr, 1.0, 1.0)
    if case == "binary_predict":
        K_s = oracles.rbf(xtr, xte, 1.0, 1.0)
        _, _, L, sW, grad = oracles.laplace_binary_mode(K, ytr)
        mean_o, var_o = oracles.laplace_binary_predict(K_s, np.ones(len(xte)), grad, L, sW)
        k = tops.RBF()
        p = convert.params_from_numpy(k.init_params())
        pred = tgp.predict_binary(k, p, tgp.fit_binary(k, p, *_t(xtr, ytr)), *_t(xtr, xte))
        _close(pred.mean, mean_o, rtol=1e-6, atol=1e-8)
        _close(pred.var, np.maximum(var_o, 0), rtol=1e-5, atol=1e-7)
        return
    f_prior = rng.standard_normal(len(ytr))
    f_o, grad_o, L_o, sW_o = oracles.laplace_binary_reference_mode(K, ytr, f_prior)
    st = tgp.laplace_fit(torch.from_numpy(K), torch.from_numpy(ytr),
                         f_init=torch.from_numpy(f_prior), mode="reference", max_iters=10000)
    assert st.converged
    _close(st.f_mode, f_o, rtol=1e-6, atol=1e-8)
    _close(st.grad_at_mode, grad_o, rtol=1e-10)
    _close(st.sqrt_w, sW_o, rtol=1e-10)
    _close(st.chol_B, L_o, rtol=1e-8, atol=1e-10)
