"""The plain reference against closed forms and against the port's own CPU
path at a tiny n."""

import math

import pytest
import torch

from conftest import TINY
from gpbench import data
from gpbench.jobs import train as train_job
from gpbench.reference import gp as ref

ORACLE = ref.Settings(ref.FLOAT64, 1e-11, 200, 2000, "column")


def _problem(seed=3000000031, n=300):
    cfg = {**TINY, "n": n, "data": {**TINY["data"], "seed": seed}}
    x, y = data.training_set(cfg, torch.device("cpu"))
    xs = data.points(cfg, 16, data.generator(torch.device("cpu"), seed, "q"), torch.device("cpu"))
    return cfg, x.double(), y.double(), xs.double()


def _dense(x1, x2, sigma=1.0, ell=2.0):
    return sigma ** 2 * torch.exp(-0.5 * torch.cdist(x1, x2) ** 2 / ell ** 2)


def test_posterior_against_the_dense_closed_form():
    cfg, x, y, xs = _problem()
    post = ref.posterior(x, y, xs, sigma=1.0, lengthscale=2.0, noise=0.01, settings=ORACLE)
    a = _dense(x, x) + 0.01 * torch.eye(x.shape[0], dtype=torch.float64)
    ks = _dense(x, xs)
    mean = ks.T @ torch.linalg.solve(a, y)
    var = 1.0 - torch.sum(ks * torch.linalg.solve(a, ks), dim=0)
    assert post.converged
    assert torch.allclose(post.mean, mean, atol=1e-8)
    assert torch.allclose(post.var, var, atol=1e-8)


def test_the_operator_and_its_parameter_products():
    _, x, _, _ = _problem(n=120)
    op = ref.RBFOperator(x, 1.3, 1.7, 0.01, ref.FLOAT64)
    op.block = 50  # several blocks
    v = torch.randn(120, 3, dtype=torch.float64)
    k = _dense(x, x, 1.3, 1.7)
    assert torch.allclose(op.matvec(v), k @ v + 0.01 * v, atol=1e-10)
    kv, ksv = op.grad_products(v)
    s = torch.cdist(x, x) ** 2 / 1.7 ** 2
    assert torch.allclose(kv, k @ v, atol=1e-10)
    assert torch.allclose(ksv, (k * s) @ v, atol=1e-10)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 3.0], dtype=torch.float32)
    assert ref.tf32_round(t).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


def test_training_against_the_dense_gradient():
    """The surrogate's gradient with exact solves is the exact LML gradient
    in expectation; with the same probes, it equals the dense surrogate's
    gradient by autograd."""
    _, x, y, _ = _problem(n=150)
    z = torch.randint(0, 2, (150, 8), generator=torch.Generator().manual_seed(3)) * 2 - 1
    run = ref.train(x, y, {"sigma": 1.3, "lengthscale": 1.7}, [z], noise=0.01,
                    learning_rate=0.05, settings=ORACLE)
    theta = torch.log(torch.tensor([1.3, 1.7], dtype=torch.float64)).requires_grad_(True)
    a = _dense(x, x, *torch.exp(theta)) + 0.01 * torch.eye(150, dtype=torch.float64)
    zz = z.double()
    with torch.no_grad():
        alpha = torch.linalg.solve(a, y)
        w = torch.linalg.solve(a, zz)
    value = (-0.5 * (2 * y @ alpha - alpha @ a @ alpha)
             - 0.5 * torch.mean(torch.sum(w * (a @ zz), dim=0)) - 75 * math.log(2 * math.pi))
    value.backward()
    assert run.values[0] == pytest.approx(float(value.detach()), rel=1e-10)
    assert run.grads[0] == pytest.approx(theta.grad.tolist(), rel=1e-7)
    # one Adam step from zero moments moves each log-param by lr * sign
    moved = [math.log(run.params[0][k]) - math.log(v)
             for k, v in (("sigma", 1.3), ("lengthscale", 1.7))]
    assert moved == pytest.approx([0.05 * math.copysign(1, g) for g in run.grads[0]], rel=1e-6)


def test_reference_against_the_ports_cpu_posterior():
    from gaussian_process_tpu_torch import gp, ops

    _, x, y, xs = _problem()
    params = {"sigma": torch.tensor(1.0, dtype=torch.float64),
              "lengthscale": torch.tensor(2.0, dtype=torch.float64)}
    port = gp.posterior(ops.RBF(), params, x, y, xs, noise_variance=0.01)
    post = ref.posterior(x, y, xs, sigma=1.0, lengthscale=2.0, noise=0.01, settings=ORACLE)
    assert torch.allclose(post.mean, port.mean, atol=1e-7)
    assert torch.allclose(post.var, port.var, atol=1e-7)


def test_reference_against_the_ports_cpu_training():
    """tune_large_scale on the CPU (a dense K, exact up to CG) in float64,
    against the reference on the same probes, drawn as the job draws them."""
    from gaussian_process_tpu_torch import ops, opt

    _, x, y, _ = _problem(n=200)
    start = {"sigma": 1.3, "lengthscale": 1.7}
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in start.items()}
    res = opt.tune_large_scale(ops.RBF(), params, x, y, noise_variance=0.01,
                               learning_rate=0.05, steps=3, num_probes=8, cg_tol=1e-10,
                               cg_max_iters=1000, precond_rank=80, seed=77)
    probes = train_job.rademacher_blocks(200, 8, 3, 77, torch.device("cpu"))
    run = ref.train(x, y, start, probes, noise=0.01, learning_rate=0.05, settings=ORACLE)
    assert run.values == pytest.approx(res.lml_trace.tolist(), rel=1e-9)
    assert run.params[-1]["sigma"] == pytest.approx(float(res.params["sigma"]), rel=1e-8)
    assert run.params[-1]["lengthscale"] == pytest.approx(float(res.params["lengthscale"]),
                                                          rel=1e-8)
