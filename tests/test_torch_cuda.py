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
    # fp32 sums over n terms in another order (the symmetric sweep's tile
    # partials are fp32 before its fixed-point sum)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("r", [1, 9, 64])
def test_sym_sweep_is_bitwise_reproducible_on_card(cuda, r):
    """K3 sums its tiles' contributions in 64-bit fixed point: two runs on
    the same inputs give equal bits (fp32 atomics did not), within the
    plain version's tolerance; one launch counted per call."""
    rng = np.random.default_rng(20 + r)
    kernel = ops.Sum(children=(ops.RBF(), ops.Matern(nu=1.5)))
    params = _params(({"sigma": 1.0, "lengthscale": 1.5}, {"sigma": 0.7, "lengthscale": 2.0}),
                     cuda)
    n = 4100  # 65 tiles, the last ragged
    x = torch.tensor(rng.uniform(-5, 5, (n, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    before = kops.launch_counts["gram_matvec_sym"]
    first = kops.gram_matvec(kernel, params, x, None, v, symmetric=True)
    second = kops.gram_matvec(kernel, params, x, None, v, symmetric=True)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_matvec_sym"] == before + 2
    assert torch.equal(first, second)
    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
    assert float((first - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("where", ["v", "params"])
def test_sym_sweep_propagates_nan_on_card(cuda, where):
    """A NaN in V makes its column NaN in every row, NaN params make every
    entry NaN, as an fp32 sum would: the integers cannot carry a NaN, so
    the kernel flags the column."""
    rng = np.random.default_rng(4)
    sigma = float("nan") if where == "params" else 1.0
    params = _params({"sigma": sigma, "lengthscale": 1.5}, cuda)
    x = torch.tensor(rng.uniform(-5, 5, (700, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((700, 9)), dtype=torch.float32, device=cuda)
    if where == "v":
        v[123, 4] = float("nan")
    out = kops.gram_matvec(ops.RBF(), params, x, None, v, symmetric=True)
    nan = torch.isnan(out)
    if where == "v":
        rest = torch.cat([out[:, :4], out[:, 5:]], dim=1)
        assert bool(nan[:, 4].all()) and bool(torch.isfinite(rest).all())
    else:
        assert bool(nan.all())


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


GRAM_FAMILIES = {
    **BWD_FAMILIES,
    "matern32": (ops.Matern(nu=1.5), {"sigma": 0.8, "lengthscale": 1.1}),
    "matern52": (ops.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 1.5}),
    "rbf_white": (ops.RBF() + ops.White(), ({"sigma": 1.0, "lengthscale": 1.5},
                                            {"amplitude": 0.3})),
    "co2": (ops.co2_kernel(), ops.co2_params_from_vector(
        torch.tensor([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19],
                     dtype=torch.float64))),
}


@pytest.mark.parametrize("name", sorted(GRAM_FAMILIES))
@pytest.mark.parametrize("n,m,d", [(193, None, 3), (300, 129, 2), (1000, 777, 5),
                                   (64, 128, 1), (150, 70, 11)])  # d > 8: the generic path
def test_tile_gram_matches_plain_on_card(cuda, name, n, m, d):
    """K1 on ragged shapes, same- and cross-set, every leaf family: within
    2e-4 x max |plain| of the plain gram on the same points in float64, and
    within 1e-4 x max(1, max |plain|) absolute (the JAX package's 1e-4
    gate, set on entries of at most 1; co2's book amplitude makes entries
    near 4.4e3, where fp32's own spacing is 4.9e-4). Float64, because the
    fp32 plain gram forms the squared distance by the norm expansion: near
    coincident points its cancellation, through sqrt, costs a family linear
    in l2 (Matern 1/2, the periodic ones) up to 1e-3, where K1's direct
    differences do not."""
    rng = np.random.default_rng(n + d)
    kernel, params = GRAM_FAMILIES[name]
    params = _params(params, cuda)
    x1 = torch.tensor(rng.uniform(-5, 5, (n, d)), dtype=torch.float32, device=cuda)
    x2 = None if m is None else torch.tensor(rng.uniform(-5, 5, (m, d)),
                                             dtype=torch.float32, device=cuda)
    before = kops.launch_counts["gram"]
    got = kops.gram(kernel, params, x1, x2)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram"] == before + 1
    want = kops.gram_reference(kernel, kops._k.tree_map_params(lambda a: a.double(), params),
                               x1.double(), None if x2 is None else x2.double())
    assert got.shape == want.shape == (n, n if m is None else m)
    err, scale = float((got.double() - want).abs().max()), float(want.abs().max())
    assert err <= 2e-4 * scale and err < 1e-4 * max(1.0, scale)


@pytest.mark.parametrize("same", [True, False])
def test_gram_ad_gradient_on_card(cuda, same):
    """K5: the gradient of sum(W * gram_ad) in the params and x through the
    tile gram's forward against autograd through the plain gram in float64
    (cross-set for the x-gradients of the Matern term, whose same-set
    diagonal puts sqrt at zero)."""
    rng = np.random.default_rng(3)
    kernel = ops.RBF() + ops.Matern(nu=2.5)
    base = _params(({"sigma": 1.0, "lengthscale": 1.5}, {"sigma": 0.7, "lengthscale": 2.0}),
                   cuda)
    x1 = torch.tensor(rng.uniform(-3, 3, (500, 3)), dtype=torch.float32, device=cuda)
    x2 = None if same else torch.tensor(rng.uniform(-3, 3, (300, 3)), dtype=torch.float32,
                                        device=cuda)
    w = torch.tensor(rng.standard_normal((500, 500 if same else 300)), dtype=torch.float32,
                     device=cuda)

    def grads(dtype, fn):
        p = _leaves_with_grad(base, dtype)
        a = x1.detach().to(dtype).requires_grad_(not same)
        b = None if same else x2.detach().to(dtype).requires_grad_(True)
        inputs = kops._k.tree_leaves(p) + ([] if same else [a, b])
        return torch.autograd.grad(torch.sum(w.to(dtype) * fn(kernel, p, a, b)), inputs)

    before = kops.launch_counts["gram_ad"]
    got = grads(torch.float32, kops.gram_ad)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_ad"] == before + 1
    want = grads(torch.float64, kops.gram_reference)
    for g, r in zip(got, want):
        err = float((g.double() - r).abs().max())
        assert err <= 1e-3 * float(r.abs().max())


def test_dispatcher_rule_on_card(cuda):
    """fp32 stationary -> the tile gram; float64, a non-stationary kernel
    and a White leaf below the top-level sum -> the plain gram."""
    x = torch.tensor(np.random.default_rng(0).uniform(-2, 2, (200, 2)), dtype=torch.float32,
                     device=cuda)
    rbf = _params({"sigma": 1.0, "lengthscale": 1.0}, cuda)
    cases = [
        (ops.RBF(), rbf, x, 1),
        (ops.RBF(), rbf, x.double(), 0),
        (ops.Linear(), _params({"offset": 0.1}, cuda), x, 0),
        (ops.RBF() * ops.White(), (rbf, _params({"amplitude": 0.5}, cuda)), x, 0),
    ]
    for kernel, params, xx, launches in cases:
        before = kops.launch_counts["gram"]
        got = kops.gram(kernel, params, xx)
        torch.cuda.synchronize()
        assert kops.launch_counts["gram"] == before + launches
        want = kops.gram_reference(kernel, params, xx)
        assert got.dtype == xx.dtype
        assert float((got.double() - want.double()).abs().max()) <= \
            2e-4 * float(want.abs().max())


def _panel_rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("b", [64, 128, 96, 1024])
def test_chol_inv_panel_matches_plain_on_card(cuda, b):
    """K6 against float64 torch.linalg within 1e-5 x max |float64| where
    its plain version is (the JAX panel bound), else within twice the plain
    version's own error; exact zeros above the diagonal; one launch (b = 64
    is one tile: init and one diagonal-tile launch)."""
    from gaussian_process_tpu_torch.ops.cuda import chol as kchol

    rng = np.random.default_rng(b)
    X = torch.tensor(rng.standard_normal((b, b)), dtype=torch.float32, device=cuda)
    A = X @ X.T / b + torch.eye(b, device=cuda)
    before = kops.launch_counts["chol_inv_panel"]
    L, W = kchol.chol_inv_panel(A)
    torch.cuda.synchronize()
    assert kops.launch_counts["chol_inv_panel"] == before + 1
    assert L.shape == W.shape == (b, b) and L.is_contiguous() and W.is_contiguous()
    Lp, Wp = kchol.chol_inv_panel_reference(A)
    L64 = torch.linalg.cholesky(A.double())
    W64 = torch.linalg.solve_triangular(L64, torch.eye(b, dtype=torch.float64, device=cuda),
                                        upper=False)
    for got, plain, ref in ((L, Lp, L64), (W, Wp, W64)):
        plain_err = _panel_rel(plain, ref)
        assert _panel_rel(got, ref) <= (1e-5 if plain_err <= 1e-5 else 2 * plain_err)
        assert bool((torch.triu(got, 1) == 0).all())


def test_chol_inv_panel_nan_on_indefinite_on_card(cuda):
    from gaussian_process_tpu_torch.ops.cuda import chol as kchol

    A = 2.0 * torch.eye(200, device=cuda)
    A[70, 70] = -1.0
    L, W = kchol.chol_inv_panel(A)
    d = torch.diagonal(L)
    assert bool(torch.isfinite(d[:70]).all()) and bool(torch.isnan(d[70:]).all())
    assert bool(torch.isnan(W[70:, :71]).all())


def test_chol_inv_panel_refuses_on_card(cuda):
    from gaussian_process_tpu_torch.ops.cuda import chol as kchol

    with pytest.raises(ValueError, match="float32"):
        kchol.chol_inv_panel(torch.eye(64, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kchol.chol_inv_panel(torch.eye(128, device=cuda)[::2, ::2])
    with pytest.raises(ValueError, match="exceeds"):
        kchol.chol_inv_panel(torch.eye(1088, device=cuda))


def test_blocked_cholesky_kernel_panels_on_card(cuda, monkeypatch):
    """blocked_cholesky(use_kernel=True) at n = 4608 (four panels of 1024
    and a ragged 512): one K6 launch per panel, a finite factor whose
    backward error max |L L^T - K| / max |K| is within twice the
    library-panel blocked factor's + 1e-7."""
    from gaussian_process_tpu_torch import linalg
    from gaussian_process_tpu_torch.linalg import blocked

    monkeypatch.setattr(blocked, "MIN_BLOCKED_N", 1024)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.uniform(-5, 5, (4608, 4)), dtype=torch.float32, device=cuda)
    K = linalg.add_diagonal(kops.gram(ops.RBF(), _params({"sigma": 1.0, "lengthscale": 1.0},
                                                         cuda), x), 5e-4)
    before = kops.launch_counts["chol_inv_panel"]
    L = linalg.blocked_cholesky(K, block=1024, use_kernel=True)
    torch.cuda.synchronize()
    assert kops.launch_counts["chol_inv_panel"] == before + 5
    L_lib = linalg.blocked_cholesky(K, block=1024)
    K64 = K.double()

    def backward_err(F):
        F64 = F.double()
        return float((F64 @ F64.T - K64).abs().max() / K64.abs().max())

    assert bool(torch.isfinite(L).all())
    assert backward_err(L) <= 2 * backward_err(L_lib) + 1e-7


def test_binary_classifier_from_numpy_goes_matrix_free_on_card(cuda):
    """From NumPy float64 at n = 40000, ``fit(solver="auto")`` stores fp32
    on the card and runs the matrix-free Newton through K3 (float64 used to
    reach ``kernel_operator``, which refuses it above n = 32768). The
    binary classifier and not ``GPRegressor``, whose ``fit`` computes a
    dense LML, about 13 GB in float64 at this n."""
    from gaussian_process_tpu_torch.models import GPBinaryClassifier

    rng = np.random.default_rng(8)
    n = 40000
    x = rng.uniform(-3, 3, (n, 2))
    y = np.where(np.sin(1.5 * x[:, 0]) - x[:, 1] > 0, 1.0, -1.0)
    before = kops.launch_counts["gram_matvec_sym"]
    model = GPBinaryClassifier(ops.RBF()).fit(x, y, solver="auto")
    torch.cuda.synchronize()
    assert model._solver == "cg" and model.x_train.dtype == torch.float32
    assert model.x_train.is_cuda and model.state.converged
    assert kops.launch_counts["gram_matvec_sym"] > before
    prob = model.predict_proba(x[:256])
    assert prob.shape == (256,) and bool(torch.isfinite(prob).all())
