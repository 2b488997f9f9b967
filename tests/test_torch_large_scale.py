"""The port's matrix-free LML training (``opt/large_scale.py``) on the CPU,
in float64: the twins of tests/test_large_scale.py, with the same bounds,
run with ``use_kernel=False`` (the dense matvec the JAX tests use), plus
the kernel path through ``ops.cuda.gram_matvec``'s autograd Function.

The port draws its probes from a ``torch.Generator`` and the JAX package
from its key, so the two estimators see different probes: each is held to
the exact LML (or its gradient), as the JAX suite holds its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops
from gaussian_process_tpu_torch.opt import large_scale as ls

NOISE = 1e-2


def _problem(rng, n=500):
    x = rng.uniform(-5, 5, (n, 3))
    y = np.sin(0.9 * x.sum(1)) + 0.05 * rng.standard_normal(n)
    return torch.from_numpy(x), torch.from_numpy(y)


def _params(p, grad=False):
    p = convert.params_from_numpy(p, dtype=torch.float64)
    return {k: v.requires_grad_(grad) for k, v in p.items()}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_surrogate_gradient_estimates_exact(rng):
    x, y = _problem(rng)
    k = tops.RBF()
    p = _params({"sigma": 1.3, "lengthscale": 1.7}, grad=True)
    exact = tgp.log_marginal_likelihood(k, p, x, y, noise_variance=NOISE)
    g_exact = torch.autograd.grad(exact, list(p.values()))
    # the port's exact gradient is the JAX package's
    jg = jax.grad(lambda pp: jgp.log_marginal_likelihood(
        jops.RBF(), pp, x.numpy(), y.numpy(), noise_variance=NOISE))(
        {"sigma": jnp.asarray(1.3), "lengthscale": jnp.asarray(1.7)})
    for key, g in zip(p, g_exact):
        np.testing.assert_allclose(float(g), float(jg[key]), rtol=1e-8)
    est = ls.lml_surrogate(k, p, x, y, _gen(1), noise_variance=NOISE, num_probes=64,
                           cg_tol=1e-10, cg_max_iters=3000, precond_rank=96,
                           use_kernel=False)
    g_est = torch.autograd.grad(est, list(p.values()))
    for key, a, b in zip(p, g_exact, g_est):
        # quadratic term is exact; logdet term is a 64-probe MC estimate
        assert abs(float(a) - float(b)) / max(abs(float(a)), 1e-9) < 0.1, (key, a, b)


def test_surrogate_quadratic_value_is_exact(rng):
    """The value = exact quadratic term + a params-independent probe
    constant (-n/2) - n/2 log 2pi."""
    x, y = _problem(rng, n=300)
    k = tops.RBF()
    p = _params({"sigma": 1.0, "lengthscale": 1.0})
    val = float(ls.lml_surrogate(k, p, x, y, _gen(0), noise_variance=NOISE, num_probes=4,
                                 cg_tol=1e-12, cg_max_iters=3000, precond_rank=64,
                                 use_kernel=False))
    post = tgp.posterior(k, p, x, y, x[:2], noise_variance=NOISE)
    quad_exact = -0.5 * float(torch.dot(y, post.alpha))
    n = x.shape[0]
    expected = quad_exact - 0.5 * n - 0.5 * n * np.log(2 * np.pi)
    assert abs(val - expected) < 1e-5 * max(abs(expected), 1.0)


def test_large_scale_training_raises_exact_lml(rng):
    x, y = _problem(rng, n=400)
    k = tops.RBF()
    p = _params({"sigma": 1.3, "lengthscale": 1.7})
    lml0 = float(tgp.log_marginal_likelihood(k, p, x, y, noise_variance=NOISE))
    res = ls.tune_large_scale(k, p, x, y, noise_variance=NOISE, steps=10, num_probes=8,
                              cg_tol=1e-6, cg_max_iters=1000, precond_rank=64,
                              learning_rate=0.1, use_kernel=False)
    lml1 = float(tgp.log_marginal_likelihood(k, res.params, x, y, noise_variance=NOISE))
    assert lml1 > lml0 + 1.0
    assert torch.isfinite(res.lml_trace).all()
    assert res.iters == 10 and len(res.cg_iters) == 10 and min(res.cg_iters) > 0
    assert not res.params["sigma"].requires_grad


def test_slq_logdet_estimates_dense(rng):
    n = 500
    x = torch.from_numpy(rng.uniform(-5, 5, (n, 3)))
    k = tops.RBF()
    p = _params({"sigma": 1.0, "lengthscale": 1.5})
    K = tops.gram(k, p, x).numpy() + NOISE * np.eye(n)
    true_logdet = float(np.linalg.slogdet(K)[1])
    est = float(ls.slq_logdet(k, p, x, _gen(0), noise_variance=NOISE, num_probes=16,
                              lanczos_iters=40, use_kernel=False))
    assert abs(est - true_logdet) / abs(true_logdet) < 0.02


def test_lml_estimate_tracks_exact(rng):
    x, y = _problem(rng, n=500)
    k = tops.RBF()
    p = _params({"sigma": 1.0, "lengthscale": 1.5})
    true_lml = float(tgp.log_marginal_likelihood(k, p, x, y, noise_variance=NOISE))
    est = float(ls.lml_estimate(k, p, x, y, _gen(0), noise_variance=NOISE, num_probes=16,
                                lanczos_iters=40, precond_rank=96, use_kernel=False))
    # SLQ's MC error is absolute on the logdet scale (O(n))
    assert abs(est - true_lml) < 0.01 * x.shape[0]


def test_surrogate_kernel_path_matches_dense_path(rng):
    """use_kernel=True (the autograd Function whose backward is the backward
    sweep; its plain versions on the CPU) gives the dense path's value and
    gradient for the same probes, with one backward sweep per step (the
    matvec on [alpha | z] carries both terms), without an x-gradient."""
    x, y = _problem(rng, n=300)
    k = tops.RBF() + tops.White()
    p = ({"sigma": torch.tensor(1.2, dtype=torch.float64, requires_grad=True),
          "lengthscale": torch.tensor(1.4, dtype=torch.float64, requires_grad=True)},
         {"amplitude": torch.tensor(0.1, dtype=torch.float64, requires_grad=True)})
    leaves = [p[0]["sigma"], p[0]["lengthscale"], p[1]["amplitude"]]
    kwargs = dict(noise_variance=NOISE, num_probes=8, cg_tol=1e-12, cg_max_iters=2000,
                  precond_rank=64)
    dense = ls.lml_surrogate(k, p, x, y, _gen(3), use_kernel=False, **kwargs)
    g_dense = torch.autograd.grad(dense, leaves)
    calls = []
    real = kops.gram_matvec_vjp_reference

    def counted(*args, **kw):
        calls.append(kw["want_dx"])
        return real(*args, **kw)

    kops.gram_matvec_vjp_reference = counted
    try:
        fused = ls.lml_surrogate(k, p, x, y, _gen(3), use_kernel=True, **kwargs)
        g_fused = torch.autograd.grad(fused, leaves)
    finally:
        kops.gram_matvec_vjp_reference = real
    assert calls == [False]
    np.testing.assert_allclose(float(fused.detach()), float(dense.detach()), rtol=1e-10)
    for a, b in zip(g_fused, g_dense):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-8)


def _two_call_objective(matvec, params, y, alpha, w, z):
    """The surrogate's terms as the JAX package forms them: the quadratic
    term from a matvec at alpha, the logdet pullback from a second at z."""
    quad = -0.5 * (2.0 * torch.dot(y, alpha) - torch.dot(alpha, matvec(params, alpha)))
    return quad - 0.5 * torch.mean(torch.sum(w * matvec(params, z), dim=0))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_merged_objective_matches_two_call_form(rng, use_kernel):
    """One matvec on [alpha | z] gives the two-call form's value and
    gradient (rtol 1e-10) on equal alpha, w and probes, through the kernel
    path's autograd Function (one backward sweep, against two) and through
    the dense path; both paths agree with each other too."""
    x, y = _problem(rng, n=200)
    k = tops.RBF() + tops.White()
    p = ({"sigma": torch.tensor(1.2, dtype=torch.float64, requires_grad=True),
          "lengthscale": torch.tensor(1.4, dtype=torch.float64, requires_grad=True)},
         {"amplitude": torch.tensor(0.1, dtype=torch.float64, requires_grad=True)})
    leaves = [p[0]["sigma"], p[0]["lengthscale"], p[1]["amplitude"]]
    alpha = torch.from_numpy(rng.standard_normal(200))
    w = torch.from_numpy(rng.standard_normal((200, 8)))
    z = ls._rademacher((200, 8), _gen(5), y)
    results = {}
    for kind in (use_kernel, not use_kernel):
        matvec = ls._make_matvec(k, x, NOISE, kind)
        for form, fn in (("merged", ls._objective), ("two_call", _two_call_objective)):
            val = fn(matvec, p, y, alpha, w, z)
            results[kind, form] = (float(val.detach()), torch.autograd.grad(val, leaves))
    want_val, want_grad = results[use_kernel, "two_call"]
    for key in [(use_kernel, "merged"), (not use_kernel, "merged")]:
        val, grad = results[key]
        np.testing.assert_allclose(val, want_val, rtol=1e-10)
        for a, b in zip(grad, want_grad):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-10)
