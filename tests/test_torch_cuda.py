"""The hand-written CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (they carry the
``requires_cuda`` marker and skip elsewhere). On the machine with the card,
which has no JAX, run them without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import ops
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _params(p, device):
    return convert.params_from_numpy(p, device=device, dtype=torch.float32)


@pytest.mark.parametrize("n,r", [(193, 1), (300, 3), (2500, 16), (700, 130)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_kernel_matches_plain_on_card(cuda, n, r, symmetric):
    rng = np.random.default_rng(n + r)
    kernel = ops.Sum(children=(ops.RBF(), ops.Matern(nu=1.5), ops.White()))
    params = _params(({"sigma": 1.0, "lengthscale": 1.5}, {"sigma": 0.7, "lengthscale": 2.0},
                      {"amplitude": 0.1}), cuda)
    x = torch.tensor(rng.uniform(-5, 5, (n, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    name = "gram_matvec_sym" if symmetric else "gram_matvec_full"
    before = kops.launch_counts[name]
    got = kops.gram_matvec(kernel, params, x, None, v, symmetric=symmetric)
    torch.cuda.synchronize()
    assert kops.launch_counts[name] == before + 1
    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
    # fp32 sums over n terms in another order (and atomics in the
    # symmetric sweep)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


def test_full_sweep_cross_set_on_card(cuda):
    rng = np.random.default_rng(1)
    kernel = ops.Periodic()
    params = _params({"period": 1.3, "lengthscale": 0.9}, cuda)
    x1 = torch.tensor(rng.uniform(-5, 5, (257, 2)), dtype=torch.float32, device=cuda)
    x2 = torch.tensor(rng.uniform(-5, 5, (129, 2)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal(129), dtype=torch.float32, device=cuda)
    got = kops.gram_matvec(kernel, params, x1, x2, v)
    want = kops.gram_matvec_reference(kernel, params, x1, x2, v)
    assert got.shape == (257,)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


def test_kernel_refuses_float64_on_card(cuda):
    x = torch.zeros((64, 2), dtype=torch.float64, device=cuda)
    params = _params({"sigma": 1.0, "lengthscale": 1.0}, cuda)
    with pytest.raises(ValueError, match="float32"):
        kops.gram_matvec(ops.RBF(), params, x, None, x[:, :1])


def test_posterior_cg_refuses_dense_float64_at_large_n(cuda):
    from gaussian_process_tpu_torch import gp
    from gaussian_process_tpu_torch.gp import regression

    n = regression.DENSE_CUDA_MAX_N + 1
    x = torch.zeros((n, 2), dtype=torch.float64, device=cuda)
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=cuda,
                                       dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 inputs"):
        gp.posterior_cg(ops.RBF(), params, x, x[:, 0], x[:4])


def _leaves_with_grad(params, dtype):
    return kops._k.tree_map_params(
        lambda a: a.detach().to(dtype).clone().requires_grad_(True), params)


@pytest.mark.parametrize("same", [True, False])
def test_params_gradient_through_cuda_matvec(cuda, same):
    """The gradient in the hyperparameters through the CUDA gram_matvec
    equals the plain version's (it used to be silently zero: the kernels
    wrote into buffers with no autograd link to the params)."""
    rng = np.random.default_rng(5)
    kernel = ops.Sum(children=(ops.RBF(), ops.Matern(nu=2.5), ops.White()))
    base = _params(({"sigma": 1.0, "lengthscale": 1.5}, {"sigma": 0.7, "lengthscale": 2.0},
                    {"amplitude": 0.1}), cuda)
    x = torch.tensor(rng.uniform(-5, 5, (700, 3)), dtype=torch.float32, device=cuda)
    x2 = None if same else torch.tensor(rng.uniform(-5, 5, (300, 3)), dtype=torch.float32,
                                        device=cuda)
    m = 700 if same else 300
    v = torch.tensor(rng.standard_normal((m, 8)), dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.standard_normal((700, 8)), dtype=torch.float32, device=cuda)
    p32 = _leaves_with_grad(base, torch.float32)
    p64 = _leaves_with_grad(base, torch.float64)
    before = kops.launch_counts["gram_matvec_bwd"]
    loss = torch.sum(w * kops.gram_matvec(kernel, p32, x, x2, v))
    got = torch.autograd.grad(loss, kops._k.tree_leaves(p32), allow_unused=True)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_matvec_bwd"] == before + 1
    ref = torch.sum(w.double() * kops.gram_matvec_reference(
        kernel, p64, x.double(), None if same else x2.double(), v.double(), same=same))
    want = torch.autograd.grad(ref, kops._k.tree_leaves(p64), allow_unused=True)
    for g, r in zip(got, want):
        g = torch.zeros(()) if g is None else g.cpu()
        r = torch.zeros((), dtype=torch.float64) if r is None else r.cpu()
        if not same and float(r) == 0.0:  # White does not reach a cross-set matvec
            assert float(g) == 0.0
            continue
        assert float(g) != 0.0
        assert abs(float(g) - float(r)) <= 1e-3 * abs(float(r))


BWD_FAMILIES = {
    "rbf": (ops.RBF(), {"sigma": 1.0, "lengthscale": 1.5}),
    "matern12": (ops.Matern(nu=0.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "periodic": (ops.Periodic(), {"period": 1.7, "lengthscale": 0.9}),
    "rq": (ops.RationalQuadratic(), {"amplitude": 0.9, "lengthscale": 1.4, "alpha": 0.6}),
    "scaled_product": (
        ops.Scaled(base=ops.RBF() * ops.DecayedPeriodic()),
        {"amplitude": 1.3, "base": ({"sigma": 1.0, "lengthscale": 2.0},
                                    {"amplitude": 1.1, "decay": 2.5, "smoothness": 0.8,
                                     "period": 1.3})},
    ),
}


@pytest.mark.parametrize("name", sorted(BWD_FAMILIES))
@pytest.mark.parametrize("same", [True, False])
def test_backward_sweep_matches_plain_vjp_on_card(cuda, name, same):
    rng = np.random.default_rng(11)
    kernel, params = BWD_FAMILIES[name]
    params = _params(params, cuda)
    n, r = 3001, 9
    x = torch.tensor(rng.uniform(-5, 5, (n, 3)), dtype=torch.float32, device=cuda)
    c = torch.mean(x, dim=0, keepdim=True)
    x1c = (x - c).contiguous()
    x2c = x1c if same else (torch.tensor(rng.uniform(-5, 5, (1507, 3)), dtype=torch.float32,
                                         device=cuda) - c).contiguous()
    v = torch.tensor(rng.standard_normal((x2c.shape[0], r)), dtype=torch.float32, device=cuda)
    ct = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    need_l2 = kops._k.needs_l2(kernel)
    d_coef, d_x = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2,
                                       want_dx=True)
    torch.cuda.synchronize()
    want, want_dx = kops.gram_matvec_vjp_reference(
        program, kops.coef_vector(coefs, dtype=torch.float64, device=cuda), x1c.double(),
        x2c.double(), v.double(), ct.double(), need_l2=need_l2, want_dx=True)
    # fp32 entry products, float64 sums: 1e-3 relative per coefficient
    assert float(torch.max(torch.abs(d_coef.double() - want) / torch.abs(want))) <= 1e-3
    # the x-gradient sums fp32 tile partials: the forward kernels' bound
    assert float(torch.max(torch.abs(d_x.double() - want_dx))) <= \
        2e-4 * float(torch.max(torch.abs(want_dx)))


def test_backward_sweep_refuses_a_large_tree(cuda):
    kernel = ops.co2_kernel()
    for _ in range(3):
        kernel = kernel + ops.co2_kernel()
    params = _params(kernel.init_params(), cuda)
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    x = torch.zeros((64, 2), dtype=torch.float32, device=cuda)
    v = torch.zeros((64, 1), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="too large"):
        kops.matvec_bwd_cuda(program, coef, x, x, v, v, need_l2=True, want_dx=False)
