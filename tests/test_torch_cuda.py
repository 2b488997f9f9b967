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
