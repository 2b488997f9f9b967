"""Gradients through the port's matrix-free matvec and CG solve, on the CPU.

- ``ops.cuda.gram_matvec`` (its autograd Function, running the plain
  versions on CPU tensors) against the JAX package's Pallas ``gram_matvec``
  custom VJP in interpret mode, float64: gradients in params, x1, x2 and v
  at rtol 1e-6, atol 1e-10 (the twins of ``TestGramMatvecVJP`` and
  ``test_vjp_through_symmetric_path`` in tests/test_pallas_ops.py).
- ``gram_matvec_vjp_reference``, the plain version of the CUDA backward
  sweep, against torch autograd through ``gram_matvec_reference`` for every
  leaf family and combinator, at rtol 1e-10.
- ``linalg.cg_solve_grad`` on the quadratic LML term against the JAX
  package's dense solve: value rtol 1e-8, gradients rtol 1e-6.
- The symmetric backward sweep (``csrc/gram_matvec_bwd_sym.cuh``) in
  float64 on the CPU: its decomposition (the work items of
  ``sym_schedule``, pair weights [ct_i | v_i] . [v_j | ct_j], half weight on
  diagonal tiles) and its compiled leaves' prescaled sums, turned into
  dL/dcoef by ``bwd_sym_coef``, against the plain VJP (rtol 1e-12 and
  1e-10); its pass widths.
- The full backward sweep (``csrc/gram_matvec_bwd.cuh``) in float64 on the
  CPU: its passes over the columns of V and ct, its split of the x2 stages
  and its 128-row blocks, a compiled leaf's S0, S1 and x-gradient sums on
  prescaled x, the interpreter's dk/dcoef and G dk/dsq (a - b) sums, each
  in the kernel's partial layout, turned into dL/dcoef and dL/dx1 by
  ``bwd_full_finish``, against the plain VJP (rtol 1e-12); its pass widths
  and its split.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.ops import pallas as pops
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import linalg as tlinalg
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])


def _pairs(a, b):
    """Matching leaves of two params trees (dict keys matched by name: JAX
    orders them, the port keeps insertion order)."""
    if isinstance(a, dict):
        for key in a:
            yield from _pairs(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            yield from _pairs(x, y)
    else:
        yield a, b


def _grad_leaves(params):
    """The port's params tree as float64 leaves that require grad."""
    p = convert.params_from_numpy(params, dtype=torch.float64)
    return tk.tree_map_params(lambda a: a.requires_grad_(True), p)


# name: (kernel, params, n, m (None: same set), d, r (None: a vector v),
#        which gradients to compare, symmetric flag)
VJP_CASES = {
    "rbf_cross_set": (jops.RBF(), {"sigma": 1.2, "lengthscale": 0.9}, 48, 40, 3, 2,
                      ("params", "x1", "x2", "v"), None),
    "rbf_white_same_set": (
        jops.RBF() + jops.White(),
        ({"sigma": 1.0, "lengthscale": 1.1}, {"amplitude": 0.5}),
        40, None, 2, None, ("params",), None,
    ),
    "rbf_symmetric_sweep": (jops.RBF(), {"sigma": 1.2, "lengthscale": 0.9}, 96, None, 2, 2,
                            ("params", "x1", "v"), True),
    "matern32_same_set": (jops.Matern(nu=1.5), {"sigma": 1.1, "lengthscale": 0.9}, 50, None,
                          2, 2, ("params",), None),
    "matern52_cross_set_x2": (jops.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 1.5}, 37, 29,
                              2, 3, ("params", "x2"), None),
}


@pytest.mark.parametrize("name", sorted(VJP_CASES))
def test_gram_matvec_grads_match_pallas_vjp(rng, name):
    jkernel, jparams, n, m, d, r, wanted, sym = VJP_CASES[name]
    x1 = rng.uniform(-3, 3, (n, d))
    x2 = None if m is None else rng.uniform(-3, 3, (m, d))
    rows = n if m is None else m
    vshape = (rows,) if r is None else (rows, r)
    oshape = (n,) if r is None else (n, r)
    v = rng.standard_normal(vshape)
    w = rng.standard_normal(oshape)
    argnums = {"params": 0, "x1": 1, "x2": 2, "v": 3}

    def loss_pallas(p, a, b, vv):
        return jnp.sum(pops.gram_matvec(jkernel, p, a, b, vv, tile_m=32, tile_n=32,
                                        interpret=True, symmetric=sym,
                                        dtype=jnp.float64) * w)

    jargs = (jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x1),
             None if x2 is None else jnp.asarray(x2), jnp.asarray(v))
    nums = tuple(argnums[k] for k in wanted)
    want_val = float(loss_pallas(*jargs))
    want = dict(zip(wanted, jax.grad(loss_pallas, argnums=nums)(*jargs)))

    tparams = _grad_leaves(jparams)
    tx1 = torch.tensor(x1, requires_grad=True)
    tx2 = None if x2 is None else torch.tensor(x2, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    out = kops.gram_matvec(convert.kernel_from_reference(jkernel), tparams, tx1, tx2, tv,
                           symmetric=sym)
    loss = torch.sum(out * torch.from_numpy(w))
    np.testing.assert_allclose(float(loss.detach()), want_val, rtol=1e-10)
    loss.backward()
    got = {"params": tk.tree_map_params(lambda a: a.grad, tparams), "x1": tx1.grad,
           "x2": None if tx2 is None else tx2.grad, "v": tv.grad}
    for key in wanted:
        for t, g in _pairs(got[key], want[key]):
            np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=1e-6, atol=1e-10,
                                       err_msg=key)


BOOK_CO2 = tops.co2_params_from_vector(torch.from_numpy(BOOK))
FAMILIES = {
    "rbf": (tops.RBF(), {"sigma": 1.3, "lengthscale": 0.7}),
    "matern12": (tops.Matern(nu=0.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern32": (tops.Matern(nu=1.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern52": (tops.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "periodic": (tops.Periodic(), {"period": 1.7, "lengthscale": 0.9}),
    "decayed_periodic": (
        tops.DecayedPeriodic(),
        {"amplitude": 1.1, "decay": 2.5, "smoothness": 0.8, "period": 1.3},
    ),
    "rq": (tops.RationalQuadratic(), {"amplitude": 0.9, "lengthscale": 1.4, "alpha": 0.6}),
    "product_scaled": (
        tops.Scaled(base=tops.RBF() * tops.Periodic()),
        {"amplitude": 1.7, "base": ({"sigma": 1.0, "lengthscale": 2.0},
                                    {"period": 1.1, "lengthscale": 0.8})},
    ),
    "co2_no_white": (tops.Sum(children=tops.co2_kernel().children[:4]), BOOK_CO2[:4]),
}


def _plain_vjp_in_params(kernel, params, x1, x2, v, ct, want_dx=True):
    """The plain backward sweep's dL/dcoef carried to the params leaves by
    autograd through the encoder, and its dL/dx1."""
    leaves = tk.tree_leaves(params)
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    c = x1.detach().mean(0, keepdim=True)
    d_coef, d_x1 = kops.gram_matvec_vjp_reference(
        program, coef.detach(), x1.detach() - c, x2.detach() - c, v, ct,
        need_l2=tk.needs_l2(kernel), want_dx=want_dx, row_chunk=16)
    d_leaves = torch.autograd.grad(coef, leaves, grad_outputs=d_coef, allow_unused=True)
    return [torch.zeros(()) if g is None else g for g in d_leaves], d_x1


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_plain_vjp_matches_autograd(rng, name):
    kernel, params = FAMILIES[name]
    params = _grad_leaves(params)
    # disjoint point sets: the autograd side takes sqrt at zero distance
    x1 = torch.tensor(rng.uniform(-3, 3, (37, 2)), requires_grad=True)
    x2 = torch.tensor(rng.uniform(-3, 3, (29, 2)))
    v = torch.tensor(rng.standard_normal((29, 3)))
    ct = torch.tensor(rng.standard_normal((37, 3)))
    loss = torch.sum(ct * kops.gram_matvec_reference(kernel, params, x1, x2, v))
    want = torch.autograd.grad(loss, [*tk.tree_leaves(params), x1])
    d_leaves, d_x1 = _plain_vjp_in_params(kernel, params, x1, x2, v, ct)
    for got, ref in zip([*d_leaves, d_x1], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_plain_vjp_at_coincident_points(rng):
    """Same-set Matern 1/2: the JAX kernel's sqrt under vjp gives NaN x-
    gradients on the diagonal; the port's rule adds nothing there, so d_x
    equals the off-diagonal sum and the params gradient is unchanged."""
    kernel, params = FAMILIES["matern12"]
    params = _grad_leaves(params)
    x = torch.tensor(rng.uniform(-3, 3, (30, 2)), requires_grad=True)
    v = torch.tensor(rng.standard_normal((30, 2)))
    ct = torch.tensor(rng.standard_normal((30, 2)))
    d_leaves, d_x1 = _plain_vjp_in_params(kernel, params, x, x, v, ct)
    # x plays both roles: the second sweep swaps them (x, x, ct, v)
    _, d_x2 = _plain_vjp_in_params(kernel, params, x, x, ct, v)
    d_x1 = d_x1 + d_x2
    assert torch.isfinite(d_x1).all()
    # reference: the dense gram with l2 held at zero on the diagonal
    eye = torch.eye(30, dtype=torch.float64)
    sq = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    l2 = torch.sqrt(sq + eye) * (1.0 - eye)
    K = tk.eval_from_distances(kernel, params, sq, l2)
    loss = torch.sum(ct * (K @ v))
    want = torch.autograd.grad(loss, [*tk.tree_leaves(params), x])
    for got, ref in zip([*d_leaves, d_x1], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_training_vjp_takes_one_sweep(rng, monkeypatch):
    """With only the params requiring grad (a training step), the backward
    runs one backward sweep and no transposed matvec."""
    calls = []
    real = kops.gram_matvec_vjp_reference

    def counted(*args, **kwargs):
        calls.append(kwargs["want_dx"])
        return real(*args, **kwargs)

    monkeypatch.setattr(kops, "gram_matvec_vjp_reference", counted)
    params = _grad_leaves({"sigma": 1.1, "lengthscale": 0.8})
    x = torch.tensor(rng.uniform(-3, 3, (60, 2)))
    v = torch.tensor(rng.standard_normal((60, 8)))
    loss = torch.sum(v * kops.gram_matvec(tops.RBF(), params, x, None, v))
    loss.backward()
    assert calls == [False]
    assert params["sigma"].grad is not None and float(params["sigma"].grad) != 0.0


def test_cg_solve_grad_quadratic_matches_jax(rng):
    n, d, noise = 200, 3, 1e-2
    x = rng.uniform(-3, 3, (n, d))
    y = rng.standard_normal(n)
    jk, jp = jops.RBF(), {"sigma": 1.1, "lengthscale": 0.8}

    def quad_dense(p):
        Km = jops.gram(jk, p, jnp.asarray(x)) + noise * jnp.eye(n, dtype=jnp.float64)
        return 0.5 * jnp.dot(y, jnp.linalg.solve(Km, y))

    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    want_val = float(quad_dense(jparams))
    want = jax.grad(quad_dense)(jparams)

    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tk_ = convert.kernel_from_reference(jk)

    def mv(p, v):
        vv = v[:, None] if v.ndim == 1 else v
        out = kops.gram_matvec(tk_, p, tx, None, vv)
        out = out[:, 0] if v.ndim == 1 else out
        return out + noise * v

    params = _grad_leaves(jp)
    val = 0.5 * torch.dot(ty, tlinalg.cg_solve_grad(mv, 1e-12, 2000, params, ty))
    np.testing.assert_allclose(float(val.detach()), want_val, rtol=1e-8)
    val.backward()
    for key in ("sigma", "lengthscale"):
        np.testing.assert_allclose(float(params[key].grad), float(want[key]), rtol=1e-6)


def test_cg_solve_grad_rhs_gradient(rng):
    """dL/db = A^{-1} x_bar, and precond_diag gets a zero gradient."""
    n = 40
    x = torch.from_numpy(rng.uniform(-3, 3, (n, 2)))
    A = tops.gram(tops.RBF(), tops.RBF().init_params(), x) + 0.1 * torch.eye(n, dtype=torch.float64)
    b = torch.tensor(rng.standard_normal(n), requires_grad=True)
    pre = torch.diagonal(A).clone().requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(n))
    params = {"scale": torch.tensor(1.0, dtype=torch.float64, requires_grad=True)}
    sol = tlinalg.cg_solve_grad(lambda p, v: p["scale"] * (A @ v), 1e-13, 500, params, b, pre)
    torch.sum(w * sol).backward()
    want_b = torch.linalg.solve(A, w)
    np.testing.assert_allclose(b.grad.numpy(), want_b.numpy(), rtol=1e-8, atol=1e-12)
    assert torch.count_nonzero(pre.grad) == 0
    # d/ds of w^T (s A)^{-1} b at s = 1 is -w^T A^{-1} b
    np.testing.assert_allclose(float(params["scale"].grad),
                               -float(w @ torch.linalg.solve(A, b.detach())), rtol=1e-8)


# ------------------------------------------- the symmetric backward sweep
#
# On the card a same-set backward that wants no x-gradient (a training
# step's) runs over the upper-triangle tiles only, each pair with the
# weight w_ij = G_ij + G_ji, half of it on a diagonal tile. Here that
# decomposition, in float64, is held to the plain VJP; the card's own runs
# are in test_torch_cuda.py.

SYM_BWD_FAMILIES = ("rbf", "matern12", "matern52", "co2_no_white")


def _sym_bwd_case(rng, name, n, r, d=3):
    """A family's program and float64 coefficients, centred points on a
    spread that gives every family entries far from 0 and 1, and V, ct."""
    kernel, params = FAMILIES[name]
    # detached: FAMILIES' co2 leaves are shared with tests that differentiate them
    params = tk.tree_map_params(lambda a: a.detach(),
                                convert.params_from_numpy(params, dtype=torch.float64))
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(rng.uniform(-3, 3, (n, d)))
    xc = x - x.mean(0, keepdim=True)
    v = torch.from_numpy(rng.standard_normal((n, r)))
    ct = torch.from_numpy(rng.standard_normal((n, r)))
    return kernel, program, coef, xc, v, ct


def _sym_bwd_strips(n, tile=64):
    """The work items of ``sym_schedule(n)`` grouped by row strip: per strip
    ti its rows, the columns of its items' tiles in the items' order, and
    each column's factor (1/2 on the diagonal tile ti, else 1)."""
    cols = {}
    for ti, j0, j1 in kops.sym_schedule(n):
        cols.setdefault(ti, []).extend(range(j0, j1))
    for ti, tiles in cols.items():
        idx = torch.cat([torch.arange(j * tile, min(n, (j + 1) * tile)) for j in tiles])
        half = torch.where(idx // tile == ti, 0.5, 1.0).to(torch.float64)
        yield torch.arange(ti * tile, min(n, (ti + 1) * tile)), idx, half


def _sym_bwd_weights(xc, v, ct, rows, cols, half, scale=1.0):
    """Pair weights [ct_i | v_i] . [v_j | ct_j] (halved on the diagonal
    tile) and squared distances of x scaled by ``scale``, for one strip."""
    w = torch.cat([ct[rows], v[rows]], 1) @ torch.cat([v[cols], ct[cols]], 1).T * half
    diff = scale * xc[rows, None, :] - scale * xc[None, cols, :]
    return w, torch.sum(diff * diff, dim=-1)


@pytest.mark.parametrize("name", SYM_BWD_FAMILIES)
@pytest.mark.parametrize("n", [3001, 200])
@pytest.mark.parametrize("r", [1, 9, 17])
def test_sym_backward_decomposition_matches_plain_vjp(rng, name, n, r):
    """The symmetric sweep's sum: over the upper-triangle tiles of the
    schedule K3 walks, each entry's dk/dcoef times its pair weight, half of
    it on a diagonal tile, equals the full sweep's sum of G_ij dk_ij/dcoef
    (the plain VJP), rtol 1e-12 in float64."""
    kernel, program, coef, xc, v, ct = _sym_bwd_case(rng, name, n, r)
    need_l2 = tk.needs_l2(kernel)
    got = torch.zeros_like(coef)
    for rows, cols, half in _sym_bwd_strips(n):
        w, sq = _sym_bwd_weights(xc, v, ct, rows, cols, half)
        got += kops._program_vjp(program, coef, sq, torch.sqrt(sq) if need_l2 else None, w)[0]
    want, _ = kops.gram_matvec_vjp_reference(program, coef, xc, xc, v, ct, need_l2=need_l2,
                                             want_dx=False, row_chunk=256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def _compiled_leaf_terms(route, sq):
    """A compiled leaf's two terms on the prescaled squared distance, in
    float64 (bs_entry in csrc/gram_matvec_bwd_sym.cuh): RBF f = 2^-sq,
    h = f sq; a Matern's s = sqrt(sq), f = p(s) e^-s, h = (p' - p) s e^-s."""
    if route == kops.OP_RBF:
        f = torch.exp2(-sq)
        return f, f * sq
    s = torch.sqrt(sq)
    e = torch.exp(-s)
    if route == kops.OP_MATERN12:
        return e, -s * e
    if route == kops.OP_MATERN32:
        return (1.0 + s) * e, -s * s * e
    return (1.0 + s + s * s / 3.0) * e, -s * s * (1.0 + s) / 3.0 * e


@pytest.mark.parametrize("name", ["rbf", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("r", [1, 9])
def test_sym_backward_compiled_leaf_sums_give_plain_vjp(rng, name, r):
    """A compiled leaf sums S0 = sum w f and S1 = sum w h on x prescaled as
    the kernel scales it (sqrt(-c1 log2 e) for RBF, c1 for a Matern), with
    no amplitude; ``bwd_sym_coef`` turns them into dL/dcoef, which equals
    the plain VJP (rtol 1e-10 in float64). The interpreter's sums are
    dL/dcoef as they are."""
    kernel, program, coef, xc, v, ct = _sym_bwd_case(rng, name, 300, r)
    route = kops.sym_route(program)
    assert route != 0
    c1 = float(coef[1])
    scale = np.sqrt(-c1 * kops.LOG2E) if route == kops.OP_RBF else c1
    sums = torch.zeros(kops.BWD_SYM_LEAF_SUMS, dtype=torch.float64)
    for rows, cols, half in _sym_bwd_strips(300):
        w, sq = _sym_bwd_weights(xc, v, ct, rows, cols, half, scale)
        f, h = _compiled_leaf_terms(route, sq)
        sums += torch.stack([torch.sum(w * f), torch.sum(w * h)])
    want, _ = kops.gram_matvec_vjp_reference(program, coef, xc, xc, v, ct,
                                             need_l2=tk.needs_l2(kernel), want_dx=False)
    got = kops.bwd_sym_coef(program, coef, sums)
    assert got.dtype == coef.dtype and got.shape == coef.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    interp = tops.RBF() + tops.RBF()
    one = {"sigma": 1.0, "lengthscale": 1.0}
    iprog, icoefs = kops.encode(interp, (one, one))
    icoef = kops.coef_vector(icoefs, dtype=torch.float32, device="cpu")
    isums = torch.arange(kops.MAX_BWD_COEF, dtype=torch.float64)
    np.testing.assert_array_equal(kops.bwd_sym_coef(iprog, icoef, isums).numpy(),
                                  np.arange(4, dtype=np.float32))


@pytest.mark.parametrize("r,passes,width", [(1, 1, 1), (2, 1, 2), (3, 1, 4), (5, 1, 6),
                                            (8, 1, 9), (9, 1, 9), (10, 1, 12), (16, 1, 16),
                                            (17, 2, 9), (33, 3, 12), (64, 4, 16)])
def test_sym_backward_passes_follow_r(r, passes, width):
    """The symmetric backward sweep's passes: the fewest of at most 16
    columns, each the least compiled width that holds its share of r (the
    training step's r = 9 in one pass of 9)."""
    assert kops.bwd_sym_passes(r) == (passes, width)
    assert passes * width >= r and width in kops.BWD_SYM_WIDTHS


def test_sym_backward_wrapper_raises_on_cpu_tensors():
    program, coefs = kops.encode(tops.RBF(), {"sigma": torch.tensor(1.0),
                                              "lengthscale": torch.tensor(1.0)})
    coef = kops.coef_vector(coefs, dtype=torch.float32, device="cpu")
    x = torch.zeros((8, 2), dtype=torch.float32)
    v = torch.zeros((8, 3), dtype=torch.float32)
    before = dict(kops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_bwd_sym_cuda(program, coef, x, v, v, need_l2=False)
    assert kops.launch_counts == before


# --------------------------------------------- the full backward sweep
#
# On the card the full sweep cuts V and ct into the passes of
# bwd_full_passes, the x2 rows into the 64-row stages of bwd_full_split's
# parts and the x1 rows into 128-row blocks; a compiled leaf sums
# S0 = sum G f, S1 = sum G h and the dx terms q (a' - b') with q = G phi on
# x prescaled as the kernel scales it, the interpreter dk/dcoef and
# G dk/dsq (a - b); bwd_full_finish sums the partials and rescales them.
# Here that decomposition, in float64, is held to the plain VJP; the card's
# own runs are in test_torch_cuda.py.


def _compiled_leaf_phi(route, sq):
    """A compiled leaf's x-gradient weight phi on the prescaled squared
    distance, in float64 (leaf_bwd_terms in csrc/gram_matvec_common.cuh):
    RBF 2^-sq, Matern 1/2 e^-s / s (0 at s = 0), 3/2 e^-s, 5/2 (1 + s) e^-s."""
    if route == kops.OP_RBF:
        return torch.exp2(-sq)
    s = torch.sqrt(sq)
    e = torch.exp(-s)
    if route == kops.OP_MATERN12:
        return torch.where(s > 0, e / torch.where(s > 0, s, torch.ones_like(s)),
                           torch.zeros_like(s))
    return e if route == kops.OP_MATERN32 else (1.0 + s) * e


def _full_bwd_partials(program, coef, x1c, x2c, v, ct, need_l2, want_dx, resident):
    """The full sweep's partials in the kernel's layout, in float64: one
    row of sums per pass, split and 128-row block (S0, S1 for a compiled
    leaf; MAX_BWD_COEF coefficients for the interpreter, whose sums over a
    pass and split go into the split's first block) and one x-gradient
    partial per pass and split."""
    n, d = x1c.shape
    m, r = v.shape
    route = kops.sym_route(program)
    passes, width, _ = kops.bwd_full_passes(r)
    splits = kops.bwd_full_split(n, m, resident)
    stages = -(-m // kops.BWD_FULL_STAGE)
    rows = -(-n // kops.BWD_FULL_ROWS)
    block = torch.arange(n) // kops.BWD_FULL_ROWS
    part = torch.zeros((passes * splits, rows, kops.BWD_SYM_LEAF_SUMS if route
                        else kops.MAX_BWD_COEF), dtype=torch.float64)
    pdx = torch.zeros((passes * splits, n, d), dtype=torch.float64) if want_dx else None
    c1 = float(coef[1]) if route else 1.0
    scale = np.sqrt(-c1 * kops.LOG2E) if route == kops.OP_RBF else c1
    xa, xb = scale * x1c, scale * x2c
    for p in range(passes):
        cols = slice(p * width, min(r, (p + 1) * width))
        for s in range(splits):
            t0, t1 = stages * s // splits, stages * (s + 1) // splits
            js = slice(t0 * kops.BWD_FULL_STAGE, min(m, t1 * kops.BWD_FULL_STAGE))
            g = ct[:, cols] @ v[js, cols].T
            diff = xa[:, None, :] - xb[None, js, :]
            sq = torch.sum(diff * diff, dim=-1)
            if route:
                f, h = _compiled_leaf_terms(route, sq)
                per_row = torch.stack([torch.sum(g * f, dim=1), torch.sum(g * h, dim=1)], 1)
                part[p * splits + s].index_add_(0, block, per_row)
                q = g * _compiled_leaf_phi(route, sq)
            else:
                dc, q = kops._program_vjp(program, coef, sq,
                                          torch.sqrt(sq) if need_l2 else None, g)
                part[p * splits + s, 0, :dc.numel()] = dc
            if want_dx:
                pdx[p * splits + s] = torch.sum(q[..., None] * diff, dim=1)
    return part.reshape(-1, part.shape[-1]), pdx


@pytest.fixture
def one_thread():
    """Torch on one thread for the test: these tests make many mid-sized
    float64 ops, which oversubscribed threads under parallel test workers
    slow many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _full_bwd_results(name, n, r, same):
    """For a family, n, r and same or cross set (inputs from the rng
    fixture's seed): the program and coefficients, the emulated partials
    with dx, and the plain VJP's (dL/dcoef, dL/dx1), computed once for the
    cases with and without dx."""
    rng = np.random.default_rng(0)
    kernel, program, coef, xc, v, ct = _sym_bwd_case(rng, name, n, r)
    x2c = xc
    if not same:
        m = n // 2 + 7
        x2c = torch.from_numpy(rng.uniform(-3, 3, (m, xc.shape[1]))) - xc.mean(0)
        v = torch.from_numpy(rng.standard_normal((m, r)))
    need_l2 = tk.needs_l2(kernel)
    part, pdx = _full_bwd_partials(program, coef, xc, x2c, v, ct, need_l2, True, 132)
    want = kops.gram_matvec_vjp_reference(program, coef, xc, x2c, v, ct, need_l2=need_l2,
                                          want_dx=True, row_chunk=256)
    return program, coef, part, pdx, want


@pytest.mark.parametrize("name", SYM_BWD_FAMILIES)
@pytest.mark.parametrize("n", [3001, 200])
@pytest.mark.parametrize("r", [1, 9, 65])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("want_dx", [False, True])
def test_full_backward_decomposition_matches_plain_vjp(one_thread, name, n, r, same, want_dx):
    """The full sweep's sum: per pass of columns, part of the x2 stages and
    block of x1 rows, a compiled leaf's S0, S1 and x-gradient sums on
    prescaled x, or the interpreter's dk/dcoef and G dk/dsq (a - b) sums,
    rescaled by ``bwd_full_finish``, equal the plain VJP (rtol 1e-12 in
    float64; dx also within 1e-12 x max |plain|, for its entries near 0).
    A cross-set x2 has a ragged n // 2 + 7 rows."""
    program, coef, part, pdx, (want, want_dx_) = _full_bwd_results(name, n, r, same)
    got, got_dx = kops.bwd_full_finish(program, coef, part, pdx if want_dx else None)
    assert got.dtype == coef.dtype and got.shape == coef.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    if want_dx:
        np.testing.assert_allclose(got_dx.numpy(), want_dx_.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(torch.max(torch.abs(want_dx_))))
    else:
        assert got_dx is None


@pytest.mark.parametrize("r,passes,width,mma", [
    (1, 1, 1, False), (2, 1, 2, False), (3, 1, 4, False), (4, 1, 4, False), (5, 1, 8, True),
    (8, 1, 8, True), (9, 1, 16, True), (16, 1, 16, True), (17, 1, 24, True),
    (33, 1, 48, True), (65, 1, 72, True), (72, 1, 72, True), (73, 2, 48, True),
    (130, 2, 72, True), (512, 8, 72, True)])
def test_full_backward_passes_follow_r(r, passes, width, mma):
    """The full backward sweep's passes: register FMAs up to
    BWD_FULL_FMA[-1] columns, then the fewest 3xTF32 MMA passes of at most
    72 columns, each the least compiled width that holds its share of r
    (the 64-probe estimator's r = 65 in one pass of 72)."""
    assert kops.bwd_full_passes(r) == (passes, width, mma)
    assert passes * width >= r
    assert width in (kops.BWD_FULL_MMA if mma else kops.BWD_FULL_FMA)
    assert mma == (r > kops.BWD_FULL_FMA[-1])


@pytest.mark.parametrize("n,m,resident,splits", [
    (4096, 4096, 132, 4), (4096, 4096, 264, 8), (102400, 102400, 132, 10),
    (102400, 51207, 132, 9), (3001, 1507, 132, 5), (200, 200, 132, 4), (64, 64, 132, 1),
    (10 ** 6, 10 ** 6, 264, 5)])
def test_full_backward_split_fills_the_card(n, m, resident, splits):
    """The split of the x2 stages: at n = 4096 the 32 row blocks alone
    would leave most of 132 SMs idle, so the stages are cut until the
    blocks fill a wave; at n = 102400 the split evens out the last wave.
    Every stage lies in exactly one part, and no part is empty."""
    got = kops.bwd_full_split(n, m, resident)
    assert got == splits
    stages = -(-m // kops.BWD_FULL_STAGE)
    assert 1 <= got <= min(stages, kops.BWD_FULL_MAX_SPLIT)
    bounds = [stages * s // got for s in range(got + 1)]
    assert bounds[0] == 0 and bounds[-1] == stages
    assert all(a < b for a, b in zip(bounds[:-1], bounds[1:]))
