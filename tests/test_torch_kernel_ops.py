"""The port's matrix-free matvec (``ops/cuda/kernel_ops.py``) on the CPU.

- Its plain version (what ``gram_matvec`` runs on a CPU tensor) against the
  JAX package's Pallas ``gram_matvec`` run in interpret mode: float64 at
  rtol 1e-9 (in f64 the Pallas output dot passes through at full
  precision), and float32 at rtol/atol 2e-4, the JAX suite's own tolerance.
- The postfix program that the CUDA kernels interpret, run by its torch
  interpreter, against ``ops.gram`` for every family (rtol 1e-12, f64).
- The sweep rule, against the rule the JAX package applies.
- The CUDA wrappers raise on CPU tensors instead of running anything.
- The symmetric sweep's fixed-point sum: the bound |k(r)| <= k(0) it rests
  on, for every family at drawn params; its scales and flags; and a NumPy
  int64 emulation that gives equal bits in any order of the adds, within
  1e-6 relative of float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.ops import pallas as pops
from gaussian_process_tpu.ops.pallas import kernel_ops as jkops
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])


def _co2_without_white():
    k = jops.co2_kernel()
    p = jops.co2_params_from_vector(jnp.asarray(BOOK))
    return jops.Sum(children=k.children[:4]), p[:4]


MATVEC_CASES = {
    "rbf_white": (
        jops.RBF() + jops.White(),
        ({"sigma": 1.3, "lengthscale": 0.7}, {"amplitude": 0.5}),
    ),
    "matern32": (jops.Matern(nu=1.5), {"sigma": 1.1, "lengthscale": 0.9}),
    "co2_no_white": _co2_without_white(),
}


def _both(name):
    jkernel, jparams = MATVEC_CASES[name]
    return jkernel, jparams, convert.kernel_from_reference(jkernel), convert.params_from_numpy(jparams)


@pytest.mark.parametrize("name", sorted(MATVEC_CASES))
@pytest.mark.parametrize("n,r", [(300, 1), (193, 3), (300, 16)])
def test_plain_matvec_same_set_matches_pallas_f64(rng, name, n, r):
    jkernel, jparams, tkernel, tparams = _both(name)
    x = rng.uniform(-5, 5, (n, 2))
    v = rng.standard_normal((n, r))
    for sym in (True, False):
        want = np.asarray(pops.gram_matvec(
            jkernel, jparams, x, None, v, tile_m=128, tile_n=128,
            interpret=True, dtype=jnp.float64, symmetric=sym,
        ))
        got = kops.gram_matvec(
            tkernel, tparams, torch.from_numpy(x), None, torch.from_numpy(v),
            symmetric=sym, row_chunk=64,
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", sorted(MATVEC_CASES))
def test_plain_matvec_cross_set_matches_pallas_f64(rng, name):
    jkernel, jparams, tkernel, tparams = _both(name)
    x1 = rng.uniform(-5, 5, (193, 2))
    x2 = rng.uniform(-5, 5, (150, 2))
    v = rng.standard_normal(150)  # a vector RHS: the (m,) form
    want = np.asarray(pops.gram_matvec(
        jkernel, jparams, x1, x2, v, tile_m=128, tile_n=128,
        interpret=True, dtype=jnp.float64,
    ))
    got = kops.gram_matvec(
        tkernel, tparams, torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(v)
    ).numpy()
    assert got.shape == (193,)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_plain_matvec_f32_matches_pallas(rng):
    jkernel, jparams, tkernel, tparams = _both("rbf_white")
    x = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    v = rng.standard_normal((300, 4)).astype(np.float32)
    want = np.asarray(pops.gram_matvec(jkernel, jparams, x, None, v, interpret=True))
    got = kops.gram_matvec(
        tkernel, convert.params_from_numpy(jparams, dtype=torch.float32),
        torch.from_numpy(x), None, torch.from_numpy(v),
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_pure_white_matvec_is_diagonal(rng):
    v = rng.standard_normal((20, 2))
    got = kops.gram_matvec(
        tops.White(), {"amplitude": torch.tensor(0.5, dtype=torch.float64)},
        torch.from_numpy(rng.uniform(-1, 1, (20, 2))), None, torch.from_numpy(v),
    )
    np.testing.assert_allclose(got.numpy(), 0.25 * v, rtol=1e-15)


def _f64(p):
    return tk.tree_map_params(lambda a: torch.as_tensor(a, dtype=torch.float64), p)


PROGRAM_CASES = {
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
    "white_in_sum": (
        tops.RBF() + tops.White(),
        ({"sigma": 1.0, "lengthscale": 1.0}, {"amplitude": 0.3}),
    ),
    "product_scaled": (
        tops.Scaled(base=tops.RBF() * tops.Periodic()),
        {"amplitude": 1.7, "base": ({"sigma": 1.0, "lengthscale": 2.0},
                                    {"period": 1.1, "lengthscale": 0.8})},
    ),
    "co2": (tops.co2_kernel(), tops.co2_params_from_vector(torch.from_numpy(BOOK))),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_postfix_program_matches_gram(rng, name):
    kernel, params = PROGRAM_CASES[name]
    params = _f64(params)
    x1 = torch.from_numpy(rng.uniform(-5, 5, (31, 2)))
    x2 = torch.from_numpy(rng.uniform(-5, 5, (17, 2)))
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    sq = tops.sqdist(x1, x2)
    got = kops.eval_program(program, coef, sq)
    # the cross-set gram: White contributes zero there, as in the tile
    want = tops.gram(kernel, params, x1, x2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-14)


def test_encoder_rejects_nonstationary():
    with pytest.raises(ValueError):
        kops.encode(tops.Linear(), {"offset": torch.tensor(0.0)})
    with pytest.raises(ValueError):
        kops.gram_matvec(tops.Linear(), {"offset": torch.tensor(0.0)},
                         torch.zeros(4, 1), None, torch.zeros(4))


@pytest.mark.parametrize(
    "n,r",
    [(2047, 9), (2048, 9), (2048, 56), (2048, 64), (2048, 65), (102400, 9),
     (102400, 65), (200000, 16), (409600, 16), (409600, 40), (300, 1)],
)
def test_sweep_rule_matches_jax(monkeypatch, n, r):
    """Both packages pick the same sweep for the same inputs: the JAX
    dispatcher is stubbed to record its choice instead of running."""
    chosen = []

    def record(kernel, tile_m, tile_n, interpret, dtype_name, sym, dot_mode, params, x1, x2, v):
        chosen.append(sym)
        return jnp.zeros((x1.shape[0], v.shape[1]), jnp.float32)

    monkeypatch.setattr(jkops, "_matvec_dispatch", record)
    x = np.zeros((n, 1), np.float32)
    pops.gram_matvec(jops.RBF(), jops.RBF().init_params(), x, None,
                     np.zeros((n, r), np.float32), interpret=True)
    assert chosen == [kops.use_symmetric(n, r)]


def test_cuda_wrappers_raise_on_cpu_tensors():
    k, p = tops.RBF(), {"sigma": torch.tensor(1.0), "lengthscale": torch.tensor(1.0)}
    program, coefs = kops.encode(k, p)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device="cpu")
    x = torch.zeros((8, 2), dtype=torch.float32)
    v = torch.zeros((8, 3), dtype=torch.float32)
    before = dict(kops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_full_cuda(program, coef, x, x, v, need_l2=False)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_sym_cuda(program, coef, x, v, need_l2=False)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_bwd_cuda(program, coef, x, x, v, v, need_l2=False, want_dx=True)
    assert kops.launch_counts == before


# ------------------------------------------------ the symmetric sweep's fixed point
#
# K3 (csrc/gram_matvec.cu) rounds each tile's contribution to an integer
# multiple of 2^-e_c and sums the integers with atomics, so the order of the
# adds cannot change the bits. Its scale rests on |k(r)| <= k(0) for every
# tree that ``encode`` builds; the card's own runs are in test_torch_cuda.py.


def _bound_family(name, u):
    """A kernel tree and its params from the positive draws ``u``."""
    rbf = (tops.RBF(), {"sigma": u[0], "lengthscale": u[1]})
    periodic = (tops.Periodic(), {"period": u[2], "lengthscale": u[3]})
    decayed = (tops.DecayedPeriodic(),
               {"amplitude": u[4], "decay": u[5], "smoothness": u[1], "period": u[2]})
    if name.startswith("matern"):
        return tops.Matern(nu={"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[name]), \
            {"sigma": u[0], "lengthscale": u[1]}
    if name == "rq":
        return tops.RationalQuadratic(), {"amplitude": u[0], "lengthscale": u[1], "alpha": u[2]}
    if name == "sum_with_white":
        return tops.Sum(children=(rbf[0], periodic[0], tops.White())), \
            (rbf[1], periodic[1], {"amplitude": u[5]})
    if name == "product":
        return tops.Matern(nu=2.5) * periodic[0], ({"sigma": u[4], "lengthscale": u[5]},
                                                   periodic[1])
    if name == "scaled_product":
        return tops.Scaled(base=rbf[0] * decayed[0]), {"amplitude": u[3],
                                                       "base": (rbf[1], decayed[1])}
    return {"rbf": rbf, "periodic": periodic, "decayed_periodic": decayed}[name]


BOUND_FAMILIES = ["rbf", "matern12", "matern32", "matern52", "periodic", "decayed_periodic",
                  "rq", "sum_with_white", "product", "scaled_product"]


@pytest.mark.parametrize("name", BOUND_FAMILIES)
def test_encoded_kernels_peak_at_distance_zero(name):
    """The fixed-point bound: for every family ``encode`` accepts, at
    drawn params, max over a grid of distances of |k(r)| <= k(0). The
    float64 evaluation may round k(r) a few ulps above k(0) near r = 0, so
    the check allows 1e-12 relative; the kernel's scale leaves a factor 4
    below int64's range."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None, database=None, derandomize=True)
    @given(st.lists(st.floats(0.05, 20.0), min_size=6, max_size=6))
    def check(u):
        kernel, params = _bound_family(name, u)
        program, coefs = kops.encode(kernel, _f64(params))
        coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
        l2 = torch.cat([torch.linspace(0.0, 1e-3, 101, dtype=torch.float64),
                        torch.linspace(0.0, 60.0, 6001, dtype=torch.float64)])
        k = kops.eval_program(program, coef, l2 * l2, l2)
        k0 = float(k[0])
        assert k0 >= 0.0 and float(torch.max(torch.abs(k))) <= k0 * (1.0 + 1e-12)

    check()


def _emulated_sym_sweep(K, v, scale, order, tile=64):
    """NumPy int64 emulation of K3 on a dense float64 K: the upper tiles'
    two contributions (T V_j -> rows i, T^T V_i -> rows j) as fp32 partials,
    each rounded half-even to round(partial 2^e_c) and added into int64
    sums in the given order of contributions (NumPy's int64 adds wrap, as
    the kernel's unsigned atomics do); then sum / 2^e_c in double, to fp32."""
    n, r = v.shape
    p = -(-n // tile)
    parts = []
    for ti in range(p):
        for tj in range(ti, p):
            I, J = slice(ti * tile, (ti + 1) * tile), slice(tj * tile, (tj + 1) * tile)
            T = K[I, J]
            parts.append((I, (T @ v[J]).astype(np.float32)))
            if ti != tj:
                parts.append((J, (T.T @ v[I]).astype(np.float32)))
    acc = np.zeros((n, r), np.int64)
    for idx in order(len(parts)):
        rows, part = parts[idx]
        acc[rows] += np.rint(part.astype(np.float64) * scale).astype(np.int64)
    return (acc.astype(np.float64) / scale).astype(np.float32)


@pytest.mark.parametrize("r", [1, 9, 64])
def test_sym_fixed_point_sum_is_order_free(rng, r):
    """The scale helper and the fixed-point sum: the same bits in every
    order of the contributions, within 1e-6 relative (to the largest
    entry) of float64 K @ V; each scale a power of two with
    k(0) sum_j |V[j, c]| scale <= 2^61 < twice that."""
    n = 300  # five 64-row tiles, the last ragged
    kernel, params = tops.RBF() + tops.Matern(nu=1.5), (
        {"sigma": 1.3, "lengthscale": 0.8}, {"sigma": 0.6, "lengthscale": 2.0})
    params = _f64(params)
    x = torch.from_numpy(rng.uniform(-4, 4, (n, 3)))
    v = rng.standard_normal((n, r)).astype(np.float32).astype(np.float64)
    v[:, 0] *= 1e3  # columns of unlike magnitude get their own scales
    K = tops.gram(kernel, params, x).numpy()
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device="cpu")
    scale, flag = kops.sym_fixed_point_scales(program, coef, torch.from_numpy(v).float())
    scale = scale.numpy()
    assert flag.dtype == torch.int32 and not flag.any()
    mant, _ = np.frexp(scale)
    assert np.all(mant == 0.5)
    bound = (1.3 ** 2 + 0.6 ** 2) * np.abs(v).sum(axis=0) * scale
    assert np.all(bound <= 2.0 ** 61 * (1 + 1e-6)) and np.all(bound > 2.0 ** 60 * (1 - 1e-6))
    orders = [lambda m: range(m), lambda m: range(m - 1, -1, -1)] + [
        (lambda m, g=np.random.default_rng(s): g.permutation(m)) for s in range(3)]
    outs = [_emulated_sym_sweep(K, v, scale, order) for order in orders]
    for out in outs[1:]:
        assert np.array_equal(out.view(np.int32), outs[0].view(np.int32))
    want = K @ v
    assert float(np.max(np.abs(outs[0] - want))) <= 1e-6 * float(np.max(np.abs(want)))


@pytest.mark.parametrize("case", ["zero_column", "nan_in_v", "inf_in_v", "nan_params"])
def test_sym_fixed_point_scales_flag_what_an_integer_cannot_hold(rng, case):
    """A column whose bound is not finite is flagged (the kernel writes
    NaN there); a zero column takes the scale 1; the others are untouched."""
    kernel = tops.RBF()
    sigma = float("nan") if case == "nan_params" else 1.0
    params = _f64({"sigma": sigma, "lengthscale": 1.0})
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device="cpu")
    v = torch.from_numpy(rng.standard_normal((100, 3))).float()
    if case == "zero_column":
        v[:, 1] = 0.0
    elif case != "nan_params":
        v[17, 1] = float("nan") if case == "nan_in_v" else float("inf")
    scale, flag = kops.sym_fixed_point_scales(program, coef, v)
    want_flag = [1, 1, 1] if case == "nan_params" else [0, int(case != "zero_column"), 0]
    assert flag.tolist() == want_flag
    assert bool(torch.isfinite(scale).all())
    if case == "zero_column":
        assert float(scale[1]) == 1.0
    if case != "nan_params":
        assert float(scale[0]) > 1.0
