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


def _tree(name, device):
    """The card tests' kernel trees: ``sum`` (RBF + Matern 3/2 + White),
    which K3 interprets, and single leaves, which K3 runs as compiled
    instantiations (``kops.sym_route``)."""
    one = {"sigma": 1.0, "lengthscale": 1.5}
    if name == "sum":
        return (ops.Sum(children=(ops.RBF(), ops.Matern(nu=1.5), ops.White())),
                _params((one, {"sigma": 0.7, "lengthscale": 2.0}, {"amplitude": 0.1}), device))
    if name == "sum_no_white":
        return (ops.Sum(children=(ops.RBF(), ops.Matern(nu=1.5))),
                _params((one, {"sigma": 0.7, "lengthscale": 2.0}), device))
    nu = {"matern32": 1.5, "matern52": 2.5}.get(name)
    return (ops.RBF() if nu is None else ops.Matern(nu=nu)), _params(one, device)


# (tree, d, n, r): the interpreted sum at d = 3 (the widths 1, 3, 16 and
# 130, which K3 sweeps in 9 passes of 16 columns); the compiled RBF at the
# paths' d = 2 and 4 and the widths 1, 3, 9; the compiled Materns at the
# other x widths (d = 1 pads to 2, 5 to 8, 9 loops) and passes
MATCH_CASES = [("sum", 3, 193, 1), ("sum", 3, 300, 3), ("sum", 3, 2500, 16), ("sum", 3, 700, 130),
               *[("rbf", d, n, r) for d in (2, 4) for n, r in ((193, 1), (300, 3), (2500, 9))],
               ("matern32", 1, 777, 33), ("matern52", 5, 2100, 9), ("matern32", 9, 300, 2)]
# the full sweep's widths besides: the serving path's 65, a whole 72, the
# binary prediction's 512 (four passes), on the compiled and interpreted routes
FULL_CASES = [(tree, d, n, r) for tree, d in (("rbf", 4), ("sum", 3))
              for n, r in ((1000, 65), (777, 72), (700, 512))]
# (sweep, dot_mode, launch count)
SWEEPS = {"sym": (True, "split3", "gram_matvec_sym"),
          "full_split3": (False, "split3", "gram_matvec_full"),
          "full_highest": (False, "highest", "gram_matvec_full")}


@pytest.mark.parametrize("sweep,tree,d,n,r",
                         [(sw, *c) for sw in SWEEPS for c in MATCH_CASES]
                         + [(sw, *c) for sw in ("full_split3", "full_highest") for c in FULL_CASES])
def test_kernel_matches_plain_on_card(cuda, sweep, tree, d, n, r):
    """Each sweep against the plain version: K3, and K2 under both
    ``dot_mode``s (3xTF32 tensor-core products under both)."""
    rng = np.random.default_rng(n + r + d)
    kernel, params = _tree(tree, cuda)
    x = torch.tensor(rng.uniform(-5, 5, (n, d)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    symmetric, dot_mode, name = SWEEPS[sweep]
    before = kops.launch_counts[name]
    got = kops.gram_matvec(kernel, params, x, None, v, symmetric=symmetric, dot_mode=dot_mode)
    torch.cuda.synchronize()
    assert kops.launch_counts[name] == before + 1
    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
    # fp32 sums over n terms in another order (the symmetric sweep's
    # partials are fp32 before its fixed-point sum; 3xTF32 is within a few
    # ulps of fp32 products, summed in fp32 a k-step at a time)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("tree", ["rbf", "sum"])
@pytest.mark.parametrize("dot_mode", ["split3", "highest"])
@pytest.mark.parametrize("r", [9, 65, 512])
def test_full_sweep_is_bitwise_reproducible_on_card(cuda, tree, dot_mode, r):
    """K2 writes every output row once, with no atomics: two runs on the
    same inputs give equal bits under both modes."""
    rng = np.random.default_rng(30 + r)
    kernel, params = _tree(tree, cuda)
    x = torch.tensor(rng.uniform(-5, 5, (1100, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((1100, r)), dtype=torch.float32, device=cuda)
    first = kops.gram_matvec(kernel, params, x, None, v, symmetric=False, dot_mode=dot_mode)
    second = kops.gram_matvec(kernel, params, x, None, v, symmetric=False, dot_mode=dot_mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("tree", ["rbf", "sum"])
@pytest.mark.parametrize("dot_mode", ["split3", "highest"])
@pytest.mark.parametrize("where", ["v", "params"])
def test_full_sweep_propagates_nan_on_card(cuda, tree, dot_mode, where):
    """A NaN in V makes its column NaN in every row and leaves the others
    finite; NaN params make every entry NaN (0 x NaN is NaN: nothing masks
    it, not the padded rows or columns)."""
    rng = np.random.default_rng(5)
    kernel, params = _tree(tree, cuda)
    if where == "params":
        params = kops._k.tree_map_params(lambda a: a * float("nan"), params)
    x = torch.tensor(rng.uniform(-5, 5, (700, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((700, 9)), dtype=torch.float32, device=cuda)
    if where == "v":
        v[123, 4] = float("nan")
    out = kops.gram_matvec(kernel, params, x, None, v, symmetric=False, dot_mode=dot_mode)
    nan = torch.isnan(out)
    if where == "v":
        rest = torch.cat([out[:, :4], out[:, 5:]], dim=1)
        assert bool(nan[:, 4].all()) and bool(torch.isfinite(rest).all())
    else:
        assert bool(nan.all())


@pytest.mark.parametrize("tree", ["rbf", "sum_no_white"])
@pytest.mark.parametrize("dot_mode", ["split3", "highest"])
def test_full_sweep_cross_set_ragged_on_card(cuda, tree, dot_mode):
    """K2 with a second point set of m = 129 rows (the "split3" route pads
    x2 to 192 rows of zero coordinates, V with zero rows) and n = 257 (a
    last block of one row), against the plain version."""
    rng = np.random.default_rng(12)
    kernel, params = _tree(tree, cuda)
    x1 = torch.tensor(rng.uniform(-5, 5, (257, 4)), dtype=torch.float32, device=cuda)
    x2 = torch.tensor(rng.uniform(-5, 5, (129, 4)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((129, 9)), dtype=torch.float32, device=cuda)
    got = kops.gram_matvec(kernel, params, x1, x2, v, dot_mode=dot_mode)
    want = kops.gram_matvec_reference(kernel, params, x1, x2, v)
    assert got.shape == (257, 9)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("tree", ["sum_no_white", "rbf"])
@pytest.mark.parametrize("r", [1, 9, 64])
def test_sym_sweep_is_bitwise_reproducible_on_card(cuda, tree, r):
    """K3 sums its partials in 64-bit fixed point: two runs on the same
    inputs give equal bits (fp32 atomics did not), on the interpreted and
    the compiled route, within the plain version's tolerance; one launch
    counted per call."""
    rng = np.random.default_rng(20 + r)
    kernel, params = _tree(tree, cuda)
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


@pytest.mark.parametrize("tree", ["rbf", "sum_no_white"])
@pytest.mark.parametrize("where", ["v", "params"])
def test_sym_sweep_propagates_nan_on_card(cuda, tree, where):
    """A NaN in V makes its column NaN in every row, NaN params make every
    entry NaN, as an fp32 sum would, on both routes: the integers cannot
    carry a NaN, so the kernel flags the column."""
    rng = np.random.default_rng(4)
    kernel, params = _tree(tree, cuda)
    if where == "params":
        params = kops._k.tree_map_params(lambda a: a * float("nan"), params)
    x = torch.tensor(rng.uniform(-5, 5, (700, 3)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((700, 9)), dtype=torch.float32, device=cuda)
    if where == "v":
        v[123, 4] = float("nan")
    out = kops.gram_matvec(kernel, params, x, None, v, symmetric=True)
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


BOOK = [66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19]
# the symmetric backward sweep's families: its compiled RBF and Matern
# routes and the interpreted co2 without White
SYM_BWD_FAMILIES = {
    "rbf": (ops.RBF(), {"sigma": 1.0, "lengthscale": 2.0}),
    "matern12": (ops.Matern(nu=0.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern52": (ops.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 1.5}),
    "co2_no_white": (ops.Sum(children=ops.co2_kernel().children[:4]),
                     ops.co2_params_from_vector(torch.tensor(BOOK, dtype=torch.float64))[:4]),
}


def _sym_bwd_inputs(cuda, name, n, r, seed):
    """A family's program and fp32 coefficients, centred fp32 points (d = 4)
    and V, ct on the card."""
    rng = np.random.default_rng(seed)
    kernel, params = SYM_BWD_FAMILIES[name]
    program, coefs = kops.encode(kernel, _params(params, cuda))
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    x = torch.tensor(rng.uniform(-5, 5, (n, 4)), dtype=torch.float32, device=cuda)
    xc = (x - torch.mean(x, dim=0, keepdim=True)).contiguous()
    v = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    ct = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    return program, coef, xc, v, ct, kops._k.needs_l2(kernel)


@pytest.mark.parametrize("name", sorted(SYM_BWD_FAMILIES))
@pytest.mark.parametrize("n", [4096, 3001])
@pytest.mark.parametrize("r", [1, 8, 9, 16, 33])
def test_sym_backward_sweep_matches_plain_vjp_on_card(cuda, name, n, r):
    """The symmetric backward sweep against the float64 plain VJP on the
    same fp32 inputs: dL/dcoef within 1e-3 relative per coefficient (fp32
    entry products, float64 sums), on the compiled routes and the
    interpreter, in one pass (r <= 16, a 9-column pass at r = 8 and 9) or
    three (r = 33); one launch counted."""
    program, coef, xc, v, ct, need_l2 = _sym_bwd_inputs(cuda, name, n, r, n + r)
    before = kops.launch_counts["gram_matvec_bwd_sym"]
    got = kops.matvec_bwd_sym_cuda(program, coef, xc, v, ct, need_l2=need_l2)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_matvec_bwd_sym"] == before + 1
    want, _ = kops.gram_matvec_vjp_reference(program, coef.double(), xc.double(), xc.double(),
                                             v.double(), ct.double(), need_l2=need_l2,
                                             want_dx=False)
    assert got.dtype == torch.float32 and got.shape == coef.shape
    assert float(torch.max(torch.abs(got.double() - want) / torch.abs(want))) <= 1e-3


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
@pytest.mark.parametrize("r", [1, 9, 33])
def test_sym_backward_sweep_is_bitwise_reproducible_on_card(cuda, name, r):
    """One float64 partial per work item, no atomics, a fixed order of the
    sums: two runs give equal bits."""
    program, coef, xc, v, ct, need_l2 = _sym_bwd_inputs(cuda, name, 4100, r, 60 + r)
    first = kops.matvec_bwd_sym_cuda(program, coef, xc, v, ct, need_l2=need_l2)
    second = kops.matvec_bwd_sym_cuda(program, coef, xc, v, ct, need_l2=need_l2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
def test_sym_backward_sweep_propagates_nan_on_card(cuda, name):
    """A NaN in V reaches every coefficient's gradient, as in the plain
    VJP."""
    program, coef, xc, v, ct, need_l2 = _sym_bwd_inputs(cuda, name, 700, 9, 3)
    v[123, 4] = float("nan")
    got = kops.matvec_bwd_sym_cuda(program, coef, xc, v, ct, need_l2=need_l2)
    assert bool(torch.isnan(got).all())


@pytest.mark.parametrize("case", ["same_coef_only", "same_with_dx", "cross_set"])
def test_backward_dispatch_on_card(cuda, case):
    """A same-set backward through the symmetric forward that wants only
    the params (a training step's) launches the symmetric backward sweep
    once and the full one never; one that wants dx, or a cross-set call,
    does the reverse. Each gradient against the plain version's in
    float64."""
    rng = np.random.default_rng(9)
    kernel, base = SYM_BWD_FAMILIES["rbf"]
    base = _params(base, cuda)
    x = torch.tensor(rng.uniform(-5, 5, (700, 3)), dtype=torch.float32, device=cuda)
    x2 = torch.tensor(rng.uniform(-5, 5, (300, 3)), dtype=torch.float32, device=cuda)
    same = case != "cross_set"
    m = 700 if same else 300
    v = torch.tensor(rng.standard_normal((m, 9)), dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.standard_normal((700, 9)), dtype=torch.float32, device=cuda)

    def grads(dtype, fn):
        p = _leaves_with_grad(base, dtype)
        a = x.detach().to(dtype).requires_grad_(case == "same_with_dx")
        b = None if same else x2.to(dtype)
        out = fn(p, a, b, v.to(dtype))
        wanted = kops._k.tree_leaves(p) + ([a] if case == "same_with_dx" else [])
        return torch.autograd.grad(torch.sum(w.to(dtype) * out), wanted)

    before = dict(kops.launch_counts)
    got = grads(torch.float32, lambda p, a, b, vv: kops.gram_matvec(kernel, p, a, b, vv,
                                                                    symmetric=True))
    torch.cuda.synchronize()
    sym = kops.launch_counts["gram_matvec_bwd_sym"] - before["gram_matvec_bwd_sym"]
    full = kops.launch_counts["gram_matvec_bwd"] - before["gram_matvec_bwd"]
    # a same-set dx takes two full sweeps (x as x1, then as x2)
    assert (sym, full) == {"same_coef_only": (1, 0), "same_with_dx": (0, 2),
                           "cross_set": (0, 1)}[case]
    want = grads(torch.float64, lambda p, a, b, vv: kops.gram_matvec_reference(
        kernel, p, a, b, vv, same=same))
    for g, r in zip(got, want):
        assert float(torch.max(torch.abs(g.double() - r))) <= 1e-3 * float(torch.max(torch.abs(r)))


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



# K4's full sweep (csrc/gram_matvec_bwd.cuh) on the symmetric sweep's four
# families (compiled RBF and Matern, co2 without White interpreted): its
# register-FMA pass (r = 1), its MMA passes (8, 16 and 72 columns, r = 130
# in two), same set and ragged cross-set m, x in registers (d = 2, 4) and in
# a loop (d = 9), dx on and off
FULL_BWD_SHAPES = [(4096, None, 4), (4096, 2055, 2), (3001, 1507, 9), (3001, None, 2)]


def _full_bwd_inputs(cuda, name, n, m, d, r, seed, spread=5.0):
    """A family's program and fp32 coefficients, centred fp32 x1 (n, d) and
    x2 (m, d; x1 itself for m = None) uniform in [-spread, spread], V and
    ct on the card."""
    rng = np.random.default_rng(seed)
    kernel, params = SYM_BWD_FAMILIES[name]
    program, coefs = kops.encode(kernel, _params(params, cuda))
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    x = torch.tensor(rng.uniform(-spread, spread, (n, d)), dtype=torch.float32, device=cuda)
    c = torch.mean(x, dim=0, keepdim=True)
    x1c = (x - c).contiguous()
    x2c = x1c if m is None else (torch.tensor(rng.uniform(-spread, spread, (m, d)),
                                              dtype=torch.float32, device=cuda) - c).contiguous()
    v = torch.tensor(rng.standard_normal((x2c.shape[0], r)), dtype=torch.float32, device=cuda)
    ct = torch.tensor(rng.standard_normal((n, r)), dtype=torch.float32, device=cuda)
    return program, coef, x1c, x2c, v, ct, kops._k.needs_l2(kernel)


def _full_bwd_gates(program, coef, x1c, x2c, v, ct, need_l2, want_dx, got, got_dx):
    """The full sweep's result against the float64 plain VJP on the same
    fp32 inputs: dL/dcoef within 1e-3 relative per coefficient (fp32 entry
    terms, float64 sums), dL/dx within 2e-4 x max |plain| (the forward
    kernels' bound)."""
    want, want_dx_ = kops.gram_matvec_vjp_reference(
        program, coef.double(), x1c.double(), x2c.double(), v.double(), ct.double(),
        need_l2=need_l2, want_dx=want_dx)
    assert got.dtype == torch.float32 and got.shape == coef.shape
    assert float(torch.max(torch.abs(got.double() - want) / torch.abs(want))) <= 1e-3
    if want_dx:
        assert bool(torch.isfinite(got_dx).all())
        assert float(torch.max(torch.abs(got_dx.double() - want_dx_))) <= \
            2e-4 * float(torch.max(torch.abs(want_dx_)))
    else:
        assert got_dx is None


@pytest.mark.parametrize("name", sorted(SYM_BWD_FAMILIES))
@pytest.mark.parametrize("r", [1, 8, 9, 16, 65, 130])
@pytest.mark.parametrize("n,m,d", FULL_BWD_SHAPES)
@pytest.mark.parametrize("want_dx", [False, True])
def test_full_backward_sweep_matches_plain_vjp_on_card(cuda, name, r, n, m, d, want_dx):
    """The full backward sweep against the float64 plain VJP; one launch
    counted."""
    args = _full_bwd_inputs(cuda, name, n, m, d, r, n + r + d)
    before = kops.launch_counts["gram_matvec_bwd"]
    got, got_dx = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=want_dx)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_matvec_bwd"] == before + 1
    _full_bwd_gates(*args, want_dx, got, got_dx)


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
@pytest.mark.parametrize("mma,width", [(False, w) for w in kops.BWD_FULL_FMA]
                         + [(True, w) for w in kops.BWD_FULL_MMA])
def test_full_backward_sweep_every_width_on_card(cuda, name, mma, width):
    """Every compiled pass width of both products for G, reached by an r
    that takes it (r = width - 1 on the MMA passes: ragged columns; 1, 2
    and 3 on the FMA passes), cross-set with dx, against the float64 plain
    VJP."""
    r = {1: 1, 2: 2, 4: 3}[width] if not mma else width - 1
    assert kops.bwd_full_passes(r) == (1, width, mma)
    args = _full_bwd_inputs(cuda, name, 1500, 777, 4, r, width)
    got, got_dx = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
    _full_bwd_gates(*args, True, got, got_dx)


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
@pytest.mark.parametrize("r", [1, 65])
@pytest.mark.parametrize("d", [200, 254])
def test_full_backward_sweep_takes_a_wide_d_on_card(cuda, name, r, d):
    """The sweep takes d = 200 and 254 (the sliced layout) on the widest
    pass as on the narrowest, cross-set with dx, against the float64 plain
    VJP. x spreads as 10 / sqrt(d), so squared distances are those of d = 4
    at spread 5."""
    args = _full_bwd_inputs(cuda, name, 700, 301, d, r, d + r, spread=10.0 / np.sqrt(d))
    got, got_dx = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
    _full_bwd_gates(*args, True, got, got_dx)


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
@pytest.mark.parametrize("r", [1, 9, 65])
def test_full_backward_sweep_is_bitwise_reproducible_on_card(cuda, name, r):
    """Partials per pass, split and row block, no atomics, a fixed order of
    the sums: two runs give equal bits, dx included."""
    args = _full_bwd_inputs(cuda, name, 4100, 3001, 4, r, 70 + r)
    first = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
    second = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
@pytest.mark.parametrize("where", ["v", "ct", "coef"])
@pytest.mark.parametrize("r", [1, 9])
def test_full_backward_sweep_propagates_nan_on_card(cuda, name, where, r):
    """A NaN in V, ct or a coefficient reaches the gradients where it
    reaches the float64 plain VJP's: with one in V or ct every
    coefficient's, with one in V every row of dx."""
    program, coef, x1c, x2c, v, ct, need_l2 = _full_bwd_inputs(cuda, name, 700, 300, 3, r, 3)
    if where == "v":
        v[123, r - 1] = float("nan")
    elif where == "ct":
        ct[45, 0] = float("nan")
    else:
        coef[1] = float("nan")
    got, got_dx = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2,
                                       want_dx=True)
    want, want_dx = kops.gram_matvec_vjp_reference(
        program, coef.double(), x1c.double(), x2c.double(), v.double(), ct.double(),
        need_l2=need_l2, want_dx=True)
    assert bool(torch.isnan(got).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isnan(got_dx), torch.isnan(want_dx))
    if where != "coef":
        assert bool(torch.isnan(got).all())
    if where == "v":
        assert bool(torch.isnan(got_dx).all())


@pytest.mark.parametrize("name", sorted(SYM_BWD_FAMILIES))
def test_full_backward_sweep_at_coincident_points_on_card(cuda, name):
    """Coincident pairs (x2 holds copies of x1 rows; the same set's
    diagonal) add nothing to dx, so Matern 1/2's 1/s weight stays finite:
    both against the float64 plain VJP, which keeps the same rule."""
    program, coef, x1c, x2c, v, ct, need_l2 = _full_bwd_inputs(cuda, name, 900, 400, 3, 9, 8)
    x2c = torch.cat([x2c, x1c[::5]]).contiguous()
    v = torch.cat([v, v[:x1c[::5].shape[0]]]).contiguous()
    for pair in ((x1c, x2c, v), (x1c, x1c, ct)):
        got, got_dx = kops.matvec_bwd_cuda(program, coef, *pair, ct, need_l2=need_l2,
                                           want_dx=True)
        _full_bwd_gates(program, coef, *pair, ct, need_l2, True, got, got_dx)

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


# K5's backward (gm_gram_bwd): the families of the tile gram, and a tree
# past the backward sweeps' 16 instructions (six scaled RBFs: 17
# instructions, 18 coefficients), which takes the instantiation sized to
# the forward's limits
GRAM_BWD_FAMILIES = {
    **{k: GRAM_FAMILIES[k] for k in ("rbf", "matern12", "matern32", "matern52", "periodic",
                                     "rq", "rbf_white", "co2")},
    "six_scaled_rbfs": (
        ops.Sum(children=tuple(ops.Scaled(base=ops.RBF()) for _ in range(6))),
        tuple({"amplitude": 0.5 + 0.1 * i, "base": {"sigma": 1.0 + 0.2 * i,
                                                    "lengthscale": 0.6 + 0.3 * i}}
              for i in range(6))),
}
# (n, m): cross-set and same-set (m None), ragged and whole tiles
GRAM_BWD_SHAPES = [(500, 300), (3001, 2049), (4096, None), (3001, None)]


def _gram_bwd_inputs(cuda, name, n, m, seed, d=3):
    """A family's program and fp32 coefficients, centred fp32 points and a
    cotangent on the card."""
    rng = np.random.default_rng(seed)
    kernel, params = GRAM_BWD_FAMILIES[name]
    program, coefs, white_idx = kops.gram_program(kernel, _params(params, cuda), m is None)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    x1 = torch.tensor(rng.uniform(-3, 3, (n, d)), dtype=torch.float32, device=cuda)
    x2 = None if m is None else torch.tensor(rng.uniform(-3, 3, (m, d)), dtype=torch.float32,
                                             device=cuda)
    x1c, x2c = kops._centred(x1, x2)
    ct = torch.tensor(rng.standard_normal((n, n if m is None else m)), dtype=torch.float32,
                      device=cuda)
    return program, coef, x1c, x2c, ct, dict(white_idx=white_idx,
                                             need_l2=kops._k.needs_l2(kernel))


@pytest.mark.parametrize("name", sorted(GRAM_BWD_FAMILIES))
@pytest.mark.parametrize("n,m", GRAM_BWD_SHAPES)
@pytest.mark.parametrize("want_dx", [False, True])
def test_gram_backward_matches_plain_vjp_on_card(cuda, name, n, m, want_dx):
    """K5's backward against the float64 plain VJP on the same fp32 inputs:
    dL/dcoef within 1e-3 per coefficient (K4's bound: fp32 entry products,
    float64 sums), dL/dx within 2e-4 x max |plain| (the forward kernels'
    bound; a same-set Matern or Periodic x-gradient is finite, coincident
    pairs adding nothing); one launch counted."""
    program, coef, x1c, x2c, ct, kw = _gram_bwd_inputs(cuda, name, n, m, n + (m or 0))
    want_dx2 = want_dx and m is not None
    before = kops.launch_counts["gram_ad_bwd"]
    got = kops.gram_bwd_cuda(program, coef, x1c, x2c, ct, want_dx1=want_dx, want_dx2=want_dx2,
                             **kw)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_ad_bwd"] == before + 1
    want = kops.gram_vjp_reference(program, coef.double(), x1c.double(),
                                   None if x2c is None else x2c.double(), ct.double(),
                                   want_dx1=want_dx, want_dx2=want_dx2, **kw)
    assert got[0].dtype == torch.float32 and got[0].shape == coef.shape
    used = want[0] != 0  # coefficients no opcode reads (a White leaf's) get exact zeros
    assert bool(torch.all(got[0][~used] == 0))
    assert float(torch.max(torch.abs(got[0].double() - want[0])[used]
                           / torch.abs(want[0][used]))) <= 1e-3
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert bool(torch.isfinite(g).all())
            assert float(torch.max(torch.abs(g.double() - w))) <= \
                2e-4 * float(torch.max(torch.abs(w)))


@pytest.mark.parametrize("name", ["rbf", "co2", "six_scaled_rbfs"])
@pytest.mark.parametrize("want_dx", [False, True])
def test_gram_backward_is_bitwise_reproducible_on_card(cuda, name, want_dx):
    """One float64 partial per block and sum, fp32 dx partials per tile, no
    atomics, a fixed order of the sums: two runs give equal bits."""
    program, coef, x1c, x2c, ct, kw = _gram_bwd_inputs(cuda, name, 3001, 2049, 5)
    runs = [kops.gram_bwd_cuda(program, coef, x1c, x2c, ct, want_dx1=want_dx,
                               want_dx2=want_dx, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("name", ["rbf", "co2"])
def test_gram_backward_propagates_nan_on_card(cuda, name):
    """A NaN in ct reaches the gradient of every coefficient the tree reads
    and the x-gradients of its row and column, as in the plain VJP."""
    program, coef, x1c, x2c, ct, kw = _gram_bwd_inputs(cuda, name, 700, None, 3)
    ct[123, 456] = float("nan")
    d_coef, d_x, _ = kops.gram_bwd_cuda(program, coef, x1c, None, ct, want_dx1=True, **kw)
    want, _, _ = kops.gram_vjp_reference(program, coef.double(), x1c.double(), None,
                                         ct.double(), want_dx1=False, **kw)
    assert torch.equal(torch.isnan(d_coef), torch.isnan(want))
    assert bool(torch.isnan(d_coef).any())
    assert bool(torch.isnan(d_x[123]).all() and torch.isnan(d_x[456]).all())


def test_gram_ad_backward_launches_the_kernel_once_on_card(cuda, monkeypatch):
    """``gram_ad``'s backward is one launch of K5's backward: no plain gram
    is recomputed (``gram_reference`` raises if called), and an expanded
    cotangent (``.sum().backward()``, stride 0) is made contiguous and
    gives the gradient of a dense one."""
    kernel, base = GRAM_FAMILIES["rbf_white"]
    x = torch.tensor(np.random.default_rng(4).uniform(-3, 3, (600, 2)), dtype=torch.float32,
                     device=cuda)
    p = _leaves_with_grad(_params(base, cuda), torch.float32)
    out = kops.gram_ad(kernel, p, x)

    def no_plain(*args, **kwargs):
        raise AssertionError("the backward recomputed the plain gram")

    monkeypatch.setattr(kops, "gram_reference", no_plain)
    before = dict(kops.launch_counts)
    out.sum().backward()
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_ad_bwd"] == before["gram_ad_bwd"] + 1
    assert kops.launch_counts["gram"] == before["gram"]
    monkeypatch.undo()
    leaves = kops._k.tree_leaves(p)
    p2 = _leaves_with_grad(_params(base, cuda), torch.float32)
    dense = torch.autograd.grad(torch.sum(torch.ones((600, 600), device=cuda)
                                          * kops.gram_ad(kernel, p2, x)),
                                kops._k.tree_leaves(p2))
    for leaf, g in zip(leaves, dense):
        assert torch.equal(leaf.grad, g)


def test_gram_backward_refuses_float64_on_card(cuda):
    program, coef, x1c, x2c, ct, kw = _gram_bwd_inputs(cuda, "rbf", 64, None, 1)
    with pytest.raises(ValueError, match="float32"):
        kops.gram_bwd_cuda(program, coef, x1c.double(), None, ct, want_dx1=False, **kw)
    with pytest.raises(ValueError, match="float32"):
        kops.gram_bwd_cuda(program, coef, x1c, None, ct.double(), want_dx1=False, **kw)


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


@pytest.mark.parametrize("tree,d,r", [("rbf", 4, 65), ("rbf", 4, 512), ("sum_no_white", 3, 65)])
def test_full_sweep_is_near_float64_on_card(cuda, tree, d, r):
    """K2's 3xTF32 product against float64: within 2e-5 x max |float64|,
    the bound chip_smoke.py holds it to at n = 102400. A 1xTF32 output
    product of the same fp32 entries, about 2^-11 a product, lands past
    it."""
    rng = np.random.default_rng(40 + r)
    kernel, params = _tree(tree, cuda)
    x = torch.tensor(rng.uniform(-5, 5, (8192, d)), dtype=torch.float32, device=cuda)
    v = torch.tensor(rng.standard_normal((8192, r)), dtype=torch.float32, device=cuda)
    got = kops.gram_matvec(kernel, params, x, None, v, symmetric=False)
    p64 = kops._k.tree_map_params(lambda a: a.double(), params)
    want = kops.gram_matvec_reference(kernel, p64, x.double(), None, v.double(), same=True)
    limit = 2e-5 * float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= limit
    K = kops._k.gram(kernel, params, x, x)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = K @ v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert float((one.double() - want).abs().max()) > limit


# Any d: K2, K3 and both K4 sweeps take the sliced layout past the widths
# at which they hold x in registers (a compiled leaf) or at full width (the
# interpreter, d <= 8). x spreads as 10 / sqrt(d), so squared distances are
# those of d = 4 at spread 5; against float64 plain versions.
WIDE_FAMILIES = ("rbf", "matern52", "co2_no_white")


def _wide_inputs(cuda, name, n, m, d, r, seed):
    return _full_bwd_inputs(cuda, name, n, m, d, r, seed, spread=10.0 / np.sqrt(d))


def _wide_forward(cuda, name, n, d, r, seed, sym):
    """The forward sweep at d: ``(got, want)``, want the float64 plain
    version on the same fp32 inputs (same set for K3, cross-set for K2)."""
    program, coef, x1c, x2c, v, _, need_l2 = _wide_inputs(cuda, name, n, None if sym else
                                                          n // 2 + 3, d, r, seed)
    kernel, params = SYM_BWD_FAMILIES[name]
    p64 = convert.params_from_numpy(params, device=cuda, dtype=torch.float64)
    before = dict(kops.launch_counts)
    if sym:
        got = kops.matvec_sym_cuda(program, coef, x1c, v, need_l2=need_l2)
    else:
        got = kops.matvec_full_cuda(program, coef, x1c, x2c, v, need_l2=need_l2)
    torch.cuda.synchronize()
    key = "gram_matvec_sym" if sym else "gram_matvec_full"
    assert kops.launch_counts[key] == before[key] + 1
    want = kops.gram_matvec_reference(kernel, p64, x1c.double(), x2c.double(), v.double(),
                                      row_chunk=256)
    return got, want


@pytest.mark.parametrize("name", WIDE_FAMILIES)
@pytest.mark.parametrize("d", [160, 512])
@pytest.mark.parametrize("sweep,r", [("full", 65), ("full", 512), ("sym", 1), ("sym", 9)])
def test_forward_sweeps_take_a_wide_d_on_card(cuda, name, d, sweep, r):
    """K2 (r = 65, 512) and K3 (r = 1, 9) at d = 160 and 512, compiled
    leaves and the interpreter, within the forward sweeps' 2e-4 x
    max |plain| of float64."""
    got, want = _wide_forward(cuda, name, 1500, d, r, d + r, sweep == "sym")
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("sweep,r", [("full", 65), ("sym", 9)])
def test_forward_sweeps_take_d_2048_on_card(cuda, sweep, r):
    got, want = _wide_forward(cuda, "co2_no_white", 700, 2048, r, r, sweep == "sym")
    assert float((got.double() - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("name", WIDE_FAMILIES)
@pytest.mark.parametrize("d", [160, 512])
def test_sym_backward_sweep_takes_a_wide_d_on_card(cuda, name, d):
    """K4's symmetric sweep at r = 9, d = 160 and 512, against the float64
    plain VJP: 1e-3 relative per coefficient."""
    program, coef, xc, _, v, ct, need_l2 = _wide_inputs(cuda, name, 1500, None, d, 9, d)
    got = kops.matvec_bwd_sym_cuda(program, coef, xc, v, ct, need_l2=need_l2)
    torch.cuda.synchronize()
    want, _ = kops.gram_matvec_vjp_reference(program, coef.double(), xc.double(), xc.double(),
                                             v.double(), ct.double(), need_l2=need_l2,
                                             want_dx=False)
    assert float(torch.max(torch.abs(got.double() - want) / torch.abs(want))) <= 1e-3


@pytest.mark.parametrize("name", WIDE_FAMILIES)
@pytest.mark.parametrize("d", [160, 512])
@pytest.mark.parametrize("r", [3, 9, 65])
def test_full_backward_sweep_takes_any_d_on_card(cuda, name, d, r):
    """K4's full sweep cross-set with dx at d = 160 and 512 (sliced), on the
    FMA pass (r = 3) and the MMA passes (r = 9, 65), against the float64
    plain VJP: dx takes the sliced layout's second walk over a stage."""
    args = _wide_inputs(cuda, name, 1100, 701, d, r, d + r)
    got, got_dx = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
    torch.cuda.synchronize()
    _full_bwd_gates(*args, True, got, got_dx)


@pytest.mark.parametrize("sweep", ["bwd_sym", "bwd_full"])
def test_backward_sweeps_take_d_2048_on_card(cuda, sweep):
    args = _wide_inputs(cuda, "co2_no_white", 600, None if sweep == "bwd_sym" else 333, 2048,
                        9, 7)
    if sweep == "bwd_sym":
        got = kops.matvec_bwd_sym_cuda(args[0], args[1], args[2], args[4], args[5],
                                       need_l2=args[6])
        _full_bwd_gates(*args, False, got, None)
    else:
        got, got_dx = kops.matvec_bwd_cuda(*args[:6], need_l2=args[6], want_dx=True)
        _full_bwd_gates(*args, True, got, got_dx)


@pytest.mark.parametrize("name", ["rbf", "co2_no_white"])
def test_wide_d_reruns_give_equal_bits_on_card(cuda, name):
    """At d = 512 K3 (fixed-point sums) and K4's full sweep (partials, no
    atomics) give equal bits on a rerun, dx included."""
    program, coef, x1c, x2c, v, ct, need_l2 = _wide_inputs(cuda, name, 2100, 1300, 512, 9, 8)
    first = kops.matvec_sym_cuda(program, coef, x1c, ct, need_l2=need_l2)
    second = kops.matvec_sym_cuda(program, coef, x1c, ct, need_l2=need_l2)
    g1 = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2, want_dx=True)
    g2 = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2, want_dx=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 t rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as the kernels' ``cvt.rna.tf32.f32`` rounds."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("name", ["rbf", "matern52"])
@pytest.mark.parametrize("sweep,r", [("full", 65), ("full", 512), ("bwd_full", 9),
                                     ("bwd_full", 65)])
def test_sliced_sweeps_are_near_float64_on_card(cuda, name, sweep, r):
    """At d = 512 (the sliced layout) on a compiled leaf, K2 within 2e-5 x
    max |float64| (the gate of test_full_sweep_is_near_float64_on_card) and
    K4's full sweep, with dx, within 2e-5 of float64 per coefficient
    (chip_smoke.py's BWD_TF32_RTOL); a 1xTF32 product of the same fp32
    inputs misses each gate. x spreads as 10 / sqrt(d) under lengthscale 8,
    so every entry is about 0.5-0.6: the off-diagonal entries carry Kv and
    dL/dcoef, and a lost slice (6% of a squared distance) would show."""
    rng = np.random.default_rng(512 + r)
    kernel = ops.Matern(nu=2.5) if name == "matern52" else ops.RBF()
    params = _params({"sigma": 1.0, "lengthscale": 8.0}, cuda)
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    need_l2 = kops._k.needs_l2(kernel)
    d, s = 512, 10.0 / np.sqrt(512)
    assert kops.sliced_layout(kops.sym_route(program), d, kops.BWD_SYM_HELD_D)
    x1, x2 = (torch.tensor(rng.uniform(-s, s, (n, d)), dtype=torch.float32, device=cuda)
              for n in (3000, 2500))
    x1c, x2c = kops._centred(x1, x2)
    v = torch.tensor(rng.standard_normal((2500, r)), dtype=torch.float32, device=cuda)
    if sweep == "full":
        got = kops.matvec_full_cuda(program, coef, x1c, x2c, v, need_l2=need_l2)
        torch.cuda.synchronize()
        p64 = kops._k.tree_map_params(lambda a: a.double(), params)
        K = kops._k.gram(kernel, p64, x1c.double(), x2c.double())
        want = K @ v.double()
        limit = 2e-5 * float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= limit
        one = _tf32(K.float()).double() @ _tf32(v).double()
        assert float((one - want).abs().max()) > limit
        return
    ct = torch.tensor(rng.standard_normal((3000, r)), dtype=torch.float32, device=cuda)
    got, got_dx = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2,
                                       want_dx=True)
    torch.cuda.synchronize()
    _full_bwd_gates(program, coef, x1c, x2c, v, ct, need_l2, True, got, got_dx)

    def vjp(vv, cc):
        want, _ = kops.gram_matvec_vjp_reference(program, coef.double(), x1c.double(),
                                                 x2c.double(), vv, cc, need_l2=need_l2,
                                                 want_dx=False)
        return want

    want = vjp(v.double(), ct.double())
    assert float(torch.max(torch.abs(got.double() - want) / torch.abs(want))) <= 2e-5
    one = vjp(_tf32(v).double(), _tf32(ct).double())
    assert float(torch.max(torch.abs(one - want) / torch.abs(want))) > 2e-5


@pytest.mark.parametrize("name", ["rbf", "matern52"])
@pytest.mark.parametrize("d", [5, 8])
@pytest.mark.parametrize("r", [1, 65, 512])
def test_full_sweep_holds_d_8_in_registers_on_card(cuda, name, d, r):
    """At 5 <= d <= 8 K2 holds a compiled leaf's x in registers, padded
    with zeros to 8 coordinates, and takes no sliced call: within 2e-5 x
    max |float64| of the plain version (the gate of
    test_full_sweep_is_near_float64_on_card), equal bits on a rerun. x
    spreads as 10 / sqrt(d) under lengthscale 4, so entries are about
    0.05-0.5 and a lost coordinate would show; x1's rows end inside a
    128-row block and x2's inside a 64-row stage."""
    rng = np.random.default_rng(80 + 10 * d + r)
    kernel = ops.Matern(nu=2.5) if name == "matern52" else ops.RBF()
    params = _params({"sigma": 1.0, "lengthscale": 4.0}, cuda)
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    need_l2 = kops._k.needs_l2(kernel)
    s = 10.0 / np.sqrt(d)
    x1, x2 = (torch.tensor(rng.uniform(-s, s, (n, d)), dtype=torch.float32, device=cuda)
              for n in (3001, 2503))
    x1c, x2c = kops._centred(x1, x2)
    v = torch.tensor(rng.standard_normal((2503, r)), dtype=torch.float32, device=cuda)
    before = dict(kops.launch_counts)
    got = kops.matvec_full_cuda(program, coef, x1c, x2c, v, need_l2=need_l2)
    again = kops.matvec_full_cuda(program, coef, x1c, x2c, v, need_l2=need_l2)
    torch.cuda.synchronize()
    assert kops.launch_counts["gram_matvec_full"] == before["gram_matvec_full"] + 2
    assert kops.launch_counts["gram_matvec_full_sliced"] == before["gram_matvec_full_sliced"]
    assert torch.equal(got, again)
    p64 = kops._k.tree_map_params(lambda a: a.double(), params)
    want = kops.gram_matvec_reference(kernel, p64, x1c.double(), x2c.double(), v.double())
    assert float((got.double() - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("kernel_id", ["K1", "K5"])
def test_tile_gram_and_its_backward_at_d_512_on_card(cuda, kernel_id):
    """K1 and K5 hold no d-wide tile; at d = 512 they still agree with the
    float64 plain gram and VJP (K1's gate of test_tile_gram_matches_plain;
    K5's 1e-3 relative per coefficient and 2e-4 x max |plain| for dx)."""
    rng = np.random.default_rng(512)
    kernel, params = SYM_BWD_FAMILIES["co2_no_white"]
    params = _params(params, cuda)
    s = 10.0 / np.sqrt(512)
    x1 = torch.tensor(rng.uniform(-s, s, (700, 512)), dtype=torch.float32, device=cuda)
    x2 = torch.tensor(rng.uniform(-s, s, (333, 512)), dtype=torch.float32, device=cuda)
    p64 = kops._k.tree_map_params(lambda a: a.double(), params)
    if kernel_id == "K1":
        got = kops.gram(kernel, params, x1, x2)
        torch.cuda.synchronize()
        want = kops.gram_reference(kernel, p64, x1.double(), x2.double(), method="diff")
        err, scale = float((got.double() - want).abs().max()), float(want.abs().max())
        assert err <= 2e-4 * scale and err < 1e-4 * max(1.0, scale)
        return
    program, coefs, white_idx = kops.gram_program(kernel, params, False)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=cuda)
    x1c, x2c = kops._centred(x1, x2)
    ct = torch.tensor(rng.standard_normal((700, 333)), dtype=torch.float32, device=cuda)
    need_l2 = kops._k.needs_l2(kernel)
    got, got_dx, _ = kops.gram_bwd_cuda(program, coef, x1c, x2c, ct, white_idx=white_idx,
                                        need_l2=need_l2, want_dx1=True)
    torch.cuda.synchronize()
    want, want_dx, _ = kops.gram_vjp_reference(program, coef.double(), x1c.double(),
                                               x2c.double(), ct.double(), white_idx=white_idx,
                                               need_l2=need_l2, want_dx1=True)
    assert float(torch.max(torch.abs(got.double() - want) / torch.abs(want))) <= 1e-3
    assert float((got_dx.double() - want_dx).abs().max()) <= \
        2e-4 * float(want_dx.abs().max())
