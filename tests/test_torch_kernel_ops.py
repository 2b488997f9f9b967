"""The port's matrix-free matvec (``ops/cuda/kernel_ops.py``) on the CPU.

- Its plain version (what ``gram_matvec`` runs on a CPU tensor) against the
  JAX package's Pallas ``gram_matvec`` run in interpret mode: float64 at
  rtol 1e-9 (in f64 the Pallas output dot passes through at full
  precision), and float32 at rtol/atol 2e-4, the JAX suite's own tolerance.
- The postfix program that the CUDA kernels interpret, run by its torch
  interpreter, against ``ops.gram`` for every family (rtol 1e-12, f64).
- The sweep rule, against the rule the JAX package applies.
- The CUDA wrappers raise on CPU tensors instead of running anything.
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
    x = torch.zeros((8, 2), dtype=torch.float32)
    v = torch.zeros((8, 3), dtype=torch.float32)
    before = dict(kops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_full_cuda(k, p, x, x, v)
    with pytest.raises(ValueError, match="CUDA"):
        kops.matvec_sym_cuda(k, p, x, v)
    assert kops.launch_counts == before
