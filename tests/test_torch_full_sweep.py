"""The full sweep (K2, ``csrc/gram_matvec_full.cuh``) and the port's
``dot_mode``, on the CPU.

- ``tf32_split``, a plain PyTorch emulation of the kernel's
  ``cvt.rna.tf32`` split: hi keeps 11 significant bits, and
  |a - hi - lo| <= 2^-21 |a|.
- The kernel's 3xTF32 product, emulated with exact float64 sums, against
  float64: within 3.01 2^-22 (|K| @ |V|), the bound of the dropped lo lo term
  and the two split residues.
- The pass widths (``full_columns``, ``full_passes``) the wrapper hands the
  kernel.
- ``gram_matvec`` takes the JAX package's ``dot_mode`` names and raises on
  any other; its plain version matches the JAX ``gram_matvec`` under both
  modes (float64 at rtol 1e-9, fp32 at the JAX suite's 2e-4).
- The four matrix-free callers hand the matvec "highest" below a CG
  tolerance of 1e-5 and "split3" at or above it, the JAX package's rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.ops import pallas as pops
from gaussian_process_tpu_torch import convert, gp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 of its 23 mantissa bits), to nearest with
    ties away from zero: the kernel's ``cvt.rna.tf32.f32``, on the bit
    pattern (adding half the dropped range to the magnitude, then clearing
    it). NaN and Inf pass through."""
    a = a.to(torch.float32)
    bits = (a.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(a), bits.view(torch.float32), a)


def tf32_split(a: torch.Tensor):
    """(hi, lo) of the full sweep's 3xTF32 product, as its staging pass
    splits V: hi = tf32(a), lo = tf32(a - hi), and lo = 0 where hi is
    infinite."""
    a = a.to(torch.float32)
    hi = tf32_round(a)
    lo = tf32_round(torch.where(torch.isinf(hi), torch.zeros_like(a), a - hi))
    return hi, lo


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The full sweep's product a @ b: both split by :func:`tf32_split`,
    lo hi + hi lo + hi hi (lo lo dropped), each product of TF32 values
    exact in float64 and summed in float64 (the kernel adds its fp32
    accumulation to that)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return al @ bh + ah @ bl + ah @ bh


def _f32_samples(rng, size=4000):
    """fp32 values over many magnitudes and both signs, with the ties of
    TF32 rounding (1 + 2^-11 and its neighbours) among them."""
    mags = np.exp2(rng.uniform(-60, 60, size)) * rng.uniform(1, 2, size)
    vals = np.where(rng.random(size) < 0.5, -mags, mags)
    ties = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11), 3.0, 0.1, 0.0])
    return torch.from_numpy(np.concatenate([vals, ties]).astype(np.float32))


def test_tf32_split_keeps_eleven_bits_and_the_rest_below_2e_21(rng):
    a = _f32_samples(rng)
    hi, lo = tf32_split(a)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        # TF32 keeps 10 of fp32's 23 mantissa bits: the low 13 are zero
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    resid = (a.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -21 * a.double().abs()).all())
    # rounding to nearest, ties away from zero
    assert tf32_round(torch.tensor([1 + 2.0 ** -11])).item() == 1 + 2.0 ** -10
    assert tf32_round(torch.tensor([-(1 + 2.0 ** -11)])).item() == -(1 + 2.0 ** -10)
    assert tf32_round(torch.tensor([1 + 2.0 ** -12])).item() == 1.0


def test_tf32_split_passes_nan_and_keeps_inf_whole():
    hi, lo = tf32_split(torch.tensor([float("nan"), float("inf"), -float("inf")]))
    assert bool(torch.isnan(hi[0])) and bool(torch.isnan(lo[0]))
    assert hi[1:].tolist() == [float("inf"), -float("inf")] and lo[1:].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("r", [1, 9, 72])
def test_tf32x3_gram_tile_product_within_bound_of_float64(rng, r):
    """An RBF gram tile (entries in (0, 1]) times V, as the kernel splits
    both: against float64 within 3.01 2^-22 (|K| @ |V|) entry by entry, and
    far inside the 2e-4 x max|plain| that the card tests hold the kernel to."""
    x1 = torch.from_numpy(rng.uniform(-3, 3, (64, 4)))
    x2 = torch.from_numpy(rng.uniform(-3, 3, (300, 4)))
    K = tops.gram(tops.RBF(), {"sigma": torch.tensor(1.0, dtype=torch.float64),
                               "lengthscale": torch.tensor(2.0, dtype=torch.float64)},
                  x1, x2).float()
    V = torch.from_numpy(rng.standard_normal((300, r))).float()
    got = tf32x3_matmul(K, V)
    exact = K.double() @ V.double()
    bound = 3.01 * 2.0 ** -22 * (K.double().abs() @ V.double().abs())
    assert bool(((got - exact).abs() <= bound).all())
    assert float((got - exact).abs().max()) <= 1e-6 * float(exact.abs().max())
    # one TF32 product alone would not be: about 2^-11 relative
    one = tf32_round(K).double() @ tf32_round(V).double()
    assert float((one - exact).abs().max()) > 10 * float((got - exact).abs().max())


@pytest.mark.parametrize("r,columns", [(1, 8), (9, 16), (65, 72), (72, 72), (130, 144),
                                       (512, 512)])
def test_full_columns_follow_r(r, columns):
    """A pass is a whole number of the MMA's 8 columns: r = 65 computes 72;
    r = 130 two passes of 72; r = 512 four passes of 128."""
    assert kops.full_columns(r) == columns
    assert kops.full_passes(512) == (4, 128)


def test_full_passes_hold_r_in_compiled_tile_counts():
    """Every pass width is a compiled count of 8-column tiles; the fewest
    passes of at most 128 columns; r rounded up to 8 wherever that is a
    compiled count."""
    for r in range(1, 1100):
        passes, width = kops.full_passes(r)
        assert width % 8 == 0 and width // 8 in kops.FULL_TILES
        assert passes * width >= r > (passes - 1) * width
        assert passes == -(-r // 128)
        if -(-r // 8) in kops.FULL_TILES:
            assert passes * width == -(-r // 8) * 8


@pytest.mark.parametrize("dot_mode", ["high", "split2", "", "HIGHEST"])
@pytest.mark.parametrize("same", [True, False])
def test_gram_matvec_raises_on_an_unknown_dot_mode(dot_mode, same):
    """Before any sweep is chosen: the symmetric and the full sweep alike."""
    p = {"sigma": torch.tensor(1.0), "lengthscale": torch.tensor(1.0)}
    x = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="dot_mode"):
        kops.gram_matvec(tops.RBF(), p, x, None if same else x, torch.zeros(8),
                         dot_mode=dot_mode)


JAX_CASES = {
    "rbf_white": (jops.RBF() + jops.White(),
                  ({"sigma": 1.3, "lengthscale": 0.7}, {"amplitude": 0.5})),
    "matern52": (jops.Matern(nu=2.5), {"sigma": 1.1, "lengthscale": 0.9}),
}


@pytest.mark.parametrize("dot_mode", ["split3", "highest"])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
@pytest.mark.parametrize("same", [True, False])
def test_plain_matvec_matches_pallas_under_both_dot_modes(rng, dot_mode, name, same):
    """The port's ``gram_matvec`` on a CPU tensor (its plain version) and
    the JAX one in interpret mode, both given ``dot_mode``: float64 at rtol
    1e-9 (the Pallas output dot passes float64 through whole), fp32 at the
    JAX suite's 2e-4 (its "split3" product carries about 1.5e-5)."""
    jkernel, jparams = JAX_CASES[name]
    tkernel = convert.kernel_from_reference(jkernel)
    x1 = rng.uniform(-5, 5, (193, 2))
    x2 = None if same else rng.uniform(-5, 5, (150, 2))
    v = rng.standard_normal((193 if same else 150, 9))
    for dtype, jdtype, tdtype, tol in ((np.float64, jnp.float64, torch.float64, 1e-9),
                                       (np.float32, jnp.float32, torch.float32, 2e-4)):
        want = np.asarray(pops.gram_matvec(
            jkernel, jparams, x1.astype(dtype), None if same else x2.astype(dtype),
            v.astype(dtype), tile_m=128, tile_n=128, interpret=True, dtype=jdtype,
            symmetric=False, dot_mode=dot_mode))
        tparams = convert.params_from_numpy(jparams, dtype=tdtype)
        got = kops.gram_matvec(
            tkernel, tparams, torch.from_numpy(x1.astype(dtype)),
            None if same else torch.from_numpy(x2.astype(dtype)),
            torch.from_numpy(v.astype(dtype)), symmetric=False, dot_mode=dot_mode).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol if dtype == np.float32 else 1e-12)


def _record_dot_modes(monkeypatch):
    seen = []
    plain = kops.gram_matvec

    def recording(*args, **kwargs):
        seen.append(kwargs.get("dot_mode", "split3"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(kops, "gram_matvec", recording)
    return seen


def _classification_data(rng, n=120):
    x = torch.from_numpy(rng.uniform(-3, 3, (n, 2)))
    y = torch.where(torch.sin(1.5 * x[:, 0]) - x[:, 1] > 0, 1.0, -1.0).double()
    y3 = ((torch.atan2(x[:, 1], x[:, 0]) + np.pi) / (2 * np.pi) * 3).long() % 3
    return x, y, y3


def _params64():
    return {"sigma": torch.tensor(1.0, dtype=torch.float64),
            "lengthscale": torch.tensor(1.0, dtype=torch.float64)}


@pytest.mark.parametrize("tol,expect", [(1e-6, "highest"), (1e-5, "split3"), (1e-4, "split3")])
@pytest.mark.parametrize("caller", ["posterior_cg", "laplace_fit_cg", "predict_binary_cg",
                                    "laplace_fit_multiclass_cg"])
def test_matrix_free_callers_pick_dot_mode_by_cg_tolerance(rng, monkeypatch, caller, tol,
                                                           expect):
    """``use_kernel=True`` on the CPU (the plain sweep): every matvec the
    caller makes gets "highest" below tol 1e-5 and "split3" at or above it,
    as ``gp/regression.py:364``, ``gp/classification.py:379`` and ``:641``
    and ``gp/multiclass.py:379`` of the JAX package choose."""
    x, y, y3 = _classification_data(rng)
    kernel, params = tops.RBF(), _params64()
    state = None
    if caller == "predict_binary_cg":
        state = gp.laplace_fit_cg(kernel, params, x, y, cg_tol=1e-6, precond_rank=32,
                                  use_kernel=True)
    seen = _record_dot_modes(monkeypatch)
    if caller == "posterior_cg":
        gp.posterior_cg(kernel, params, x, torch.sin(x[:, 0]), x[:7] + 0.05, tol=tol,
                        noise_variance=1e-2, use_kernel=True, preconditioner="jacobi")
    elif caller == "laplace_fit_cg":
        gp.laplace_fit_cg(kernel, params, x, y, cg_tol=tol, precond_rank=32, use_kernel=True)
    elif caller == "predict_binary_cg":
        gp.predict_binary_cg(kernel, params, state, x, x[:9] + 0.05, cg_tol=tol,
                             use_kernel=True)
    else:
        gp.laplace_fit_multiclass_cg(kernel, params, x, y3, 3, cg_tol=tol, precond_rank=32,
                                     use_kernel=True)
    assert seen and set(seen) == {expect}
    assert gp.regression.cg_dot_mode(tol) == expect
