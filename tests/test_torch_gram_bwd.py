"""The tile gram's backward (K5) of the port on the CPU, in float64.

- Its plain version (``kernel_ops.gram_vjp_reference``, which ``gram_ad``'s
  backward runs on a CPU tensor) against torch autograd through the plain
  ``ops.gram``: rtol 1e-10 (atol 1e-12 of the largest entry, for entries
  that cancel), every family of ``tests/test_torch_gram.py``, same-set and
  cross-set, with and without the x-gradients, on ragged n, m. Where a
  same-set gram of a family that reads l2 = sqrt(sq) puts sqrt at zero on
  the diagonal (NaN x-gradients under autograd), the autograd side holds l2
  at zero there, which is the port's rule: a coincident pair adds nothing
  to dx.
- The CUDA kernel's compiled route: its sums S0, S1 (and the x-gradient's
  weights) on prescaled x, emulated in float64 and rescaled by
  ``bwd_sym_coef`` and ``gram_bwd_dx_scale``, against the plain version:
  rtol 1e-10.
- A tree past the backward sweeps' 16 instructions, through ``gram_ad``.
- The CUDA wrapper refuses CPU tensors.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])

# tests/test_torch_gram.py's CASES, in the port's types
CASES = {
    "rbf": (tk.RBF(), {"sigma": 1.5, "lengthscale": 0.8}),
    "matern12": (tk.Matern(nu=0.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern32": (tk.Matern(nu=1.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern52": (tk.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "periodic": (tk.Periodic(), {"period": 1.7, "lengthscale": 0.9}),
    "rq": (tk.RationalQuadratic(), {"amplitude": 0.9, "lengthscale": 1.4, "alpha": 0.6}),
    "rbf_white": (tk.RBF() + tk.White(),
                  ({"sigma": 1.0, "lengthscale": 1.1}, {"amplitude": 0.3})),
    "co2": (tk.co2_kernel(), tk.co2_params_from_vector(torch.from_numpy(BOOK))),
}


def _params(name):
    kernel, params = CASES[name]
    return kernel, tk.tree_map_params(
        lambda a: a.detach(), convert.params_from_numpy(params, dtype=torch.float64))


def _points(rng, n, m, d=2, scale=3.0):
    x1 = torch.from_numpy(rng.uniform(-scale, scale, (n, d)))
    x2 = None if m is None else torch.from_numpy(rng.uniform(-scale, scale, (m, d)))
    return x1, x2


def _autograd(kernel, params, x1, x2, ct, want_dx):
    """Gradients of <ct, K> in the params leaves and (want_dx) the points,
    by autograd through the plain gram with direct differences; a same-set
    gram of a family that reads l2 holds l2 at zero on the diagonal."""
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    a = x1.clone().requires_grad_(want_dx)
    b = None if x2 is None else x2.clone().requires_grad_(want_dx)
    if x2 is None and tk.needs_l2(kernel):
        base, bp, white = tk.split_white(kernel, p)
        sq = torch.sum((a[:, None, :] - a[None, :, :]) ** 2, dim=-1)
        eye = torch.eye(a.shape[0], dtype=a.dtype)
        K = tk.eval_from_distances(base, bp, sq, torch.sqrt(sq + eye) * (1.0 - eye))
        if white is not None:
            K = K + white * eye
    else:
        K = tk.gram(kernel, p, a, b, method="diff")
    wanted = tk.tree_leaves(p) + ([a] + ([] if b is None else [b]) if want_dx else [])
    grads = torch.autograd.grad(torch.sum(ct * K), wanted, allow_unused=True)
    return [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wanted)]


def _plain(kernel, params, x1, x2, ct, want_dx, **kw):
    """The plain VJP's gradients in the params leaves (dL/dcoef carried on
    by autograd through the coefficient vector) and the points."""
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    program, coefs, white_idx = kops.gram_program(kernel, p, x2 is None)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    c = x1.mean(0, keepdim=True)
    d_coef, d_x1, d_x2 = kops.gram_vjp_reference(
        program, coef.detach(), x1 - c, None if x2 is None else x2 - c, ct,
        white_idx=white_idx, need_l2=tk.needs_l2(kernel), want_dx1=want_dx,
        want_dx2=want_dx and x2 is not None, **kw)
    leaves = tk.tree_leaves(p)
    d_leaves = torch.autograd.grad(coef, leaves, grad_outputs=d_coef, allow_unused=True)
    d_leaves = [torch.zeros_like(w) if g is None else g for g, w in zip(d_leaves, leaves)]
    return d_leaves + ([d_x1] + ([] if x2 is None else [d_x2]) if want_dx else [])


def _close(got, want, rtol=1e-10):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        scale = float(torch.max(torch.abs(w))) if w.numel() else 0.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=1e-12 * max(scale, 1.0))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("want_dx", [False, True])
def test_plain_vjp_matches_autograd(rng, name, same, want_dx):
    kernel, params = _params(name)
    x1, x2 = _points(rng, 37, None if same else 29)
    ct = torch.from_numpy(rng.standard_normal((37, 37 if same else 29)))
    got = _plain(kernel, params, x1, x2, ct, want_dx, row_chunk=8)
    _close(got, _autograd(kernel, params, x1, x2, ct, want_dx))


def _leaf_sums(route, sq, ct):
    """A compiled leaf's float64 sums on the prescaled squared distance, as
    ``leaf_bwd_terms`` (csrc/gram_matvec_common.cuh) forms them: S0 = sum ct f,
    S1 = sum ct h, and the x-gradient's weights ct phi."""
    if route == kops.OP_RBF:
        f = torch.exp2(-sq)
        return torch.sum(ct * f), torch.sum(ct * f * sq), ct * f
    s = torch.sqrt(sq)
    e = torch.exp(-s)
    if route == kops.OP_MATERN12:
        phi = torch.where(s > 0, e / torch.where(s > 0, s, torch.ones_like(s)), 0.0)
        return torch.sum(ct * e), torch.sum(-ct * s * e), ct * phi
    if route == kops.OP_MATERN32:
        return torch.sum(ct * (1 + s) * e), torch.sum(-ct * s * s * e), ct * e
    return (torch.sum(ct * (1 + s + s * s / 3) * e), torch.sum(-ct * s * s * (1 + s) / 3 * e),
            ct * (1 + s) * e)


@pytest.mark.parametrize("name,same", [
    *[(name, same) for name in ("rbf", "matern12", "matern32", "matern52")
      for same in (True, False)],
    ("rbf_white", True),  # cross-set, White is a zero leaf: the interpreter
])
def test_compiled_route_sums_give_plain_vjp(rng, name, same):
    """The kernel's compiled route, emulated in float64: x prescaled (RBF
    by sqrt(-c1 log2 e), a Matern by c1), S0, S1 and the trace summed,
    ``bwd_sym_coef`` and White's trace give dL/dcoef, and the weights' row
    and column sums of (x'_i - x'_j) times ``gram_bwd_dx_scale`` give
    dL/dx1 and dL/dx2: each within rtol 1e-10 of the plain VJP. The same
    set holds White's variance after the leaf's coefficients (rbf_white)."""
    kernel, params = _params(name)
    x1, x2 = _points(rng, 45, None if same else 33, d=3)
    ct = torch.from_numpy(rng.standard_normal((45, 45 if same else 33)))
    program, coefs, white_idx = kops.gram_program(kernel, params, same)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    route = kops.sym_route(program)
    assert route != 0
    c1 = float(coef[1])
    scale = np.sqrt(-c1 * kops.LOG2E) if route == kops.OP_RBF else c1
    c = x1.mean(0, keepdim=True)
    x1c, x2c = x1 - c, (x1 if same else x2) - c
    diff = scale * x1c[:, None, :] - scale * x2c[None, :, :]
    s0, s1, q = _leaf_sums(route, torch.sum(diff * diff, dim=-1), ct)
    got = kops.bwd_sym_coef(program, coef, torch.stack([s0, s1]))
    assert got.shape == coef.shape
    if white_idx >= 0:
        got[white_idx] += torch.trace(ct)
    dx_scale = kops.gram_bwd_dx_scale(program, coef)
    dx1 = dx_scale * torch.sum(q[:, :, None] * diff, dim=1)
    dx2 = -dx_scale * torch.sum(q[:, :, None] * diff, dim=0)
    want, want_dx1, want_dx2 = kops.gram_vjp_reference(
        program, coef, x1c, None if same else x2c, ct, white_idx=white_idx,
        need_l2=tk.needs_l2(kernel), want_dx1=True, want_dx2=not same)
    _close([got, dx1 + dx2 if same else dx1], [want, want_dx1])
    if not same:
        _close([dx2], [want_dx2])


def _six_scaled_rbfs():
    kernel = tk.Sum(children=tuple(tk.Scaled(base=tk.RBF()) for _ in range(6)))
    params = tuple({"amplitude": torch.tensor(0.5 + 0.1 * i, dtype=torch.float64),
                    "base": {"sigma": torch.tensor(1.0 + 0.2 * i, dtype=torch.float64),
                             "lengthscale": torch.tensor(0.6 + 0.3 * i, dtype=torch.float64)}}
                   for i in range(6))
    return kernel, params


def test_a_tree_past_sixteen_instructions_is_differentiable(rng):
    """A sum of six scaled RBFs (17 instructions, 18 coefficients: past the
    backward sweeps' 16) through ``gram_ad``, whose CPU backward is the plain
    version, against autograd through the plain gram, both point sets."""
    kernel, params = _six_scaled_rbfs()
    program, coefs = kops.encode(kernel, params)
    assert len(program) > kops.MAX_BWD_INSTR and len(coefs) > kops.MAX_BWD_COEF
    x1, x2 = _points(rng, 31, 23)
    ct = torch.from_numpy(rng.standard_normal((31, 23)))
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    a, b = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
    wanted = tk.tree_leaves(p) + [a, b]
    got = torch.autograd.grad(torch.sum(ct * kops.gram_ad(kernel, p, a, b)), wanted)
    _close(list(got), _autograd(kernel, params, x1, x2, ct, True))


@pytest.mark.parametrize("name", ["matern12", "periodic"])
def test_coincident_pairs_add_nothing_to_dx(rng, name):
    """A same-set Matern 1/2 or Periodic gram whose points include a
    repeated one: autograd through the plain gram gives NaN x-gradients
    there (sqrt at zero); ``gram_ad``'s backward gives finite ones, equal to
    autograd with l2 held at zero on every coincident pair."""
    kernel, params = _params(name)
    x = torch.from_numpy(rng.uniform(-3, 3, (30, 2)))
    x[7] = x[19]
    ct = torch.from_numpy(rng.standard_normal((30, 30)))
    a = x.clone().requires_grad_(True)
    (nan_side,) = torch.autograd.grad(torch.sum(ct * tk.gram(kernel, params, a, method="diff")),
                                      [a])
    assert not bool(torch.isfinite(nan_side).all())
    a = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(ct * kops.gram_ad(kernel, params, a)), [a])
    assert bool(torch.isfinite(got).all())
    a = x.clone().requires_grad_(True)
    sq = torch.sum((a[:, None, :] - a[None, :, :]) ** 2, dim=-1)
    zero = (sq.detach() == 0).to(sq.dtype)
    K = tk.eval_from_distances(kernel, params, sq, torch.sqrt(sq + zero) * (1.0 - zero))
    (want,) = torch.autograd.grad(torch.sum(ct * K), [a])
    _close([got], [want])


def test_backward_runs_the_plain_vjp_once_and_no_gram(rng, monkeypatch):
    """On a CPU tensor the backward is one call of the plain VJP: the plain
    gram runs once, in the forward, and is not recomputed; an expanded
    cotangent (``.sum().backward()``) is taken."""
    kernel, params = _params("rbf_white")
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    calls = {"vjp": 0, "gram": 0}
    real_vjp, real_gram = kops.gram_vjp_reference, kops.gram_reference

    def vjp(*args, **kwargs):
        calls["vjp"] += 1
        return real_vjp(*args, **kwargs)

    def gram(*args, **kwargs):
        calls["gram"] += 1
        return real_gram(*args, **kwargs)

    monkeypatch.setattr(kops, "gram_vjp_reference", vjp)
    monkeypatch.setattr(kops, "gram_reference", gram)
    x = torch.from_numpy(rng.uniform(-2, 2, (40, 2)))
    kops.gram_ad(kernel, p, x).sum().backward()
    assert calls == {"vjp": 1, "gram": 1}
    want = _autograd(kernel, params, x, None, torch.ones((40, 40), dtype=torch.float64), False)
    _close([leaf.grad for leaf in tk.tree_leaves(p)], want)


def test_white_amplitude_gets_a_zero_gradient_cross_set(rng):
    """A cross-set gram evaluates White as zero, so its amplitude's gradient
    is zero, as autograd through the plain gram gives it: the White leaf
    carries its variance in the coefficient vector, which no opcode reads."""
    kernel, params = _params("rbf_white")
    program, coefs = kops.encode(kernel, params)
    assert program[1] == (kops.OP_ZERO, 2) and len(coefs) == 3
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    x1, x2 = _points(rng, 12, 9)
    ct = torch.from_numpy(rng.standard_normal((12, 9)))
    grads = torch.autograd.grad(torch.sum(ct * kops.gram_ad(kernel, p, x1, x2)),
                                tk.tree_leaves(p))
    assert float(grads[-1]) == 0.0 and float(grads[0]) != 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_wrapper_refuses_cpu_tensors(dtype):
    program, coefs, white_idx = kops.gram_program(tk.RBF(), {"sigma": 1.0, "lengthscale": 1.0},
                                                  True)
    coef = kops.coef_vector(coefs, dtype=dtype, device="cpu")
    x = torch.zeros((8, 2), dtype=dtype)
    ct = torch.zeros((8, 8), dtype=dtype)
    before = dict(kops.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kops.gram_bwd_cuda(program, coef, x, None, ct, white_idx=white_idx, need_l2=False,
                           want_dx1=False)
    assert kops.launch_counts == before


def test_same_set_plain_vjp_refuses_a_second_point_set():
    x = torch.zeros((4, 2), dtype=torch.float64)
    coef = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="one point set"):
        kops.gram_vjp_reference([(kops.OP_RBF, 0)], coef, x, None, torch.zeros((4, 4)),
                                want_dx2=True)


def test_nested_white_on_the_cpu_differentiates_the_plain_gram(rng):
    """A White leaf below the top-level sum, which the tile gram's function
    evaluates as zero: on a CPU tensor ``gram_ad`` is the plain gram under
    autograd, so its gradients are the plain gram's, White's amplitude
    included."""
    kernel = tk.RBF() * tk.White() + tk.Matern(nu=2.5)
    params = convert.params_from_numpy((({"sigma": 1.2, "lengthscale": 0.7}, {"amplitude": 0.4}),
                                        {"sigma": 0.9, "lengthscale": 1.3}), dtype=torch.float64)
    assert kops.nested_white(kernel)
    x = torch.from_numpy(rng.uniform(-2, 2, (25, 2)))
    ct = torch.from_numpy(rng.standard_normal((25, 25)))
    p = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    got = torch.autograd.grad(torch.sum(ct * kops.gram_ad(kernel, p, x)), tk.tree_leaves(p))
    q = tk.tree_map_params(lambda a: a.clone().requires_grad_(True), params)
    want = torch.autograd.grad(torch.sum(ct * tk.gram(kernel, q, x)), tk.tree_leaves(q))
    assert float(want[2]) != 0.0
    _close(list(got), list(want), rtol=1e-12)
