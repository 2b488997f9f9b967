"""The port's blocked Cholesky, its triangular solves and the panel factor K6
(plain version) against the JAX package's, on the same inputs made with
numpy; and the estimators' default device.

``MIN_BLOCKED_N`` is lowered to 256 in both packages, so the multi-panel
branch runs at CPU sizes (the JAX suite's ``tests/test_blocked.py`` does the
same). Float64 comparisons use that suite's tolerances (factor rtol 1e-8,
atol 1e-9; solves rtol 1e-7, atol 1e-8). The fp32 panel comparisons use its
panel bound, 1e-5 x max |reference|: both versions run the same pivot
recurrence in fp32 and differ only in the order of sums. The JAX panel
kernel runs in Pallas interpret mode, as the JAX suite runs it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solve_triangular

from gaussian_process_tpu.linalg import blocked as jblocked
from gaussian_process_tpu.ops.pallas.chol import chol_inv_panel as jchol_inv_panel
from gaussian_process_tpu_torch import linalg as tlinalg
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.linalg import blocked as tblocked
from gaussian_process_tpu_torch.models import (GPBinaryClassifier, GPMulticlassClassifier,
                                               GPRegressor)
from gaussian_process_tpu_torch.ops.cuda import chol as tchol
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

PANEL_RTOL = 1e-5


def _spd(rng, n, jitter=1e-3):
    x = rng.uniform(-5, 5, (n, 4))
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * sq) + jitter * np.eye(n)


def _panel(rng, b):
    X = rng.standard_normal((b, b)).astype(np.float32)
    return X @ X.T / b + np.eye(b, dtype=np.float32)


@pytest.fixture
def small_threshold(monkeypatch):
    monkeypatch.setattr(jblocked, "MIN_BLOCKED_N", 256)
    monkeypatch.setattr(tblocked, "MIN_BLOCKED_N", 256)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------ blocked factor


@pytest.mark.parametrize("n,block", [(608, 128), (1184, 256), (300, 128)])
def test_torch_blocked_cholesky_matches_jax(rng, small_threshold, n, block):
    """Multi-panel with a ragged tail panel: 608 = 4 x 128 + 96,
    1184 = 4 x 256 + 160, and 300 = 2 x 128 + 44 just above the patched
    threshold."""
    K = _spd(rng, n)
    want = np.asarray(jblocked.blocked_cholesky(jnp.asarray(K), block=block, use_pallas=False))
    got = tlinalg.blocked_cholesky(torch.from_numpy(K), block=block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)
    assert np.all(np.triu(got, 1) == 0.0)
    # the alias names the algorithm, as in the JAX package
    assert tblocked.leftlook_cholesky is tblocked.blocked_cholesky


def test_torch_blocked_cholesky_delegates_at_small_n(rng):
    K = _spd(rng, 64)
    want = np.asarray(jblocked.blocked_cholesky(jnp.asarray(K), use_pallas=False))
    np.testing.assert_allclose(tlinalg.blocked_cholesky(torch.from_numpy(K)).numpy(), want,
                               rtol=1e-8, atol=1e-9)
    with pytest.raises(ValueError, match="single"):
        tlinalg.blocked_cholesky(torch.from_numpy(np.stack([K, K])))


def test_torch_blocked_trsm_via_inverse_matches_jax(rng, small_threshold):
    K = _spd(rng, 608)
    want = np.asarray(jblocked.blocked_cholesky(jnp.asarray(K), block=128,
                                                trsm_via_inverse=True))
    got = tlinalg.blocked_cholesky(torch.from_numpy(K), block=128, trsm_via_inverse=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("where", ["leading", "trailing"])
@pytest.mark.parametrize("panels", ["library", "kernel"])
def test_torch_blocked_nan_on_indefinite(rng, small_threshold, where, panels):
    """An indefinite pivot in the first panel or in the last one NaNs the
    factor's diagonal, with the library panels (float64) and with K6's
    plain version (fp32: kernel panels are fp32 only), as the JAX
    factorization does."""
    n = 384
    K = _spd(rng, n)
    i = 10 if where == "leading" else n - 1
    K[i, i] = -1e3
    dtype = torch.float64 if panels == "library" else torch.float32
    L = tlinalg.blocked_cholesky(torch.from_numpy(K).to(dtype), block=128,
                                 use_kernel=panels == "kernel")
    assert torch.isnan(torch.diagonal(L)).any()
    jdtype = jnp.float32 if panels == "kernel" else jnp.float64
    jL = np.asarray(jblocked.blocked_cholesky(jnp.asarray(K, dtype=jdtype), block=128,
                                              use_pallas=panels == "kernel"))
    assert np.isnan(np.diag(jL)).any()


def test_torch_blocked_kernel_panels_match_jax(rng, small_threshold):
    """fp32 with kernel panels (K6's plain version here) against the JAX
    factorization with Pallas panels in interpret mode, within 1e-5
    relative; both near the float64 factor."""
    K = _spd(rng, 300).astype(np.float32)
    want = np.asarray(jblocked.blocked_cholesky(jnp.asarray(K), block=128, use_pallas=True))
    got = tlinalg.blocked_cholesky(torch.from_numpy(K), block=128, use_kernel=True).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) < PANEL_RTOL
    L64 = np.linalg.cholesky(K.astype(np.float64))
    assert _rel(got, L64) < PANEL_RTOL and _rel(want, L64) < PANEL_RTOL
    assert np.all(np.triu(got, 1) == 0.0)


def test_torch_blocked_kernel_panel_rule(rng, small_threshold, monkeypatch):
    """The JAX ``_use_pallas_panels`` rule, decided before any launch: K6
    panels for fp32 with ``use_kernel=True`` only; None and float64 take the
    library panels."""
    calls = []
    real = tchol.chol_inv_panel

    def spy(A):
        calls.append(A.shape)
        return real(A)

    monkeypatch.setattr(tchol, "chol_inv_panel", spy)
    K = torch.from_numpy(_spd(rng, 300))
    cases = [(K, True, 0), (K, None, 0), (K.float(), None, 0), (K.float(), False, 0),
             (K.float(), True, 3)]
    for mat, use_kernel, panels in cases:
        calls.clear()
        L = tlinalg.blocked_cholesky(mat, block=128, use_kernel=use_kernel)
        assert len(calls) == panels and L.dtype == mat.dtype
    assert calls == [(128, 128), (128, 128), (44, 44)]


def test_torch_blocked_precision_is_scoped(rng, small_threshold):
    """"high" (TF32 products on the card) and "highest" give the exact fp32
    products on the CPU, and the TF32 flag is restored after the call."""
    K = torch.from_numpy(_spd(rng, 300)).float()
    before = torch.backends.cuda.matmul.allow_tf32
    high = tlinalg.blocked_cholesky(K, block=128, precision="high")
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert torch.equal(high, tlinalg.blocked_cholesky(K, block=128))
    with pytest.raises(ValueError, match="precision"):
        tlinalg.blocked_cholesky(K, block=128, precision="default")
    assert torch.backends.cuda.matmul.allow_tf32 == before


# ------------------------------------------------------------ blocked solves


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_torch_blocked_tri_solve_matches_jax(rng, small_threshold, trans, shared):
    """Forward and transposed, with the panel inverses made inside or shared
    through ``panel_inverses`` (the pattern of one factor serving both
    solves)."""
    n = 608
    L = np.linalg.cholesky(_spd(rng, n))
    B = rng.standard_normal((n, 8))
    jinvs = jblocked.panel_inverses(jnp.asarray(L), block=128) if shared else None
    tinvs = tlinalg.panel_inverses(torch.from_numpy(L), block=128) if shared else None
    if shared:
        assert [t.shape for t in tinvs] == [(128, 128)] * 4 + [(96, 96)]
        for t, j in zip(tinvs, jinvs):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7, atol=1e-8)
    want = np.asarray(jblocked.blocked_tri_solve(jnp.asarray(L), jnp.asarray(B), trans=trans,
                                                 block=128, invs=jinvs))
    got = tlinalg.blocked_tri_solve(torch.from_numpy(L), torch.from_numpy(B), trans=trans,
                                    block=128, invs=tinvs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(got, solve_triangular(L.T if trans else L, B, lower=not trans),
                               rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("n", [384, 200])
def test_torch_blocked_tri_solve_vector_rhs(rng, small_threshold, n):
    """A vector right-hand side, on the blocked branch (384) and delegated
    to one library solve (200 <= the patched threshold)."""
    L = np.linalg.cholesky(_spd(rng, n))
    b = rng.standard_normal(n)
    for trans in (False, True):
        want = np.asarray(jblocked.blocked_tri_solve(jnp.asarray(L), jnp.asarray(b),
                                                     trans=trans, block=128))
        got = tlinalg.blocked_tri_solve(torch.from_numpy(L), torch.from_numpy(b), trans=trans,
                                        block=128).numpy()
        assert got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)


# ------------------------------------------------------------ the panel (K6)


@pytest.mark.parametrize("b", [128, 96, 256])
def test_torch_chol_inv_panel_reference_matches_jax(rng, b):
    """K6's plain version against the JAX ``chol_inv_panel`` (interpret
    mode; 96 takes its identity padding, 256 its two sub-panels and the
    block inverse assembly), both near float64 numpy, upper triangles
    exactly zero."""
    A = _panel(rng, b)
    jL, jW = (np.asarray(t) for t in jchol_inv_panel(jnp.asarray(A), interpret=True))
    L, W = tchol.chol_inv_panel(torch.from_numpy(A))
    assert L.dtype == W.dtype == torch.float32 and L.shape == W.shape == (b, b)
    L, W = L.numpy(), W.numpy()
    assert _rel(L, jL) < PANEL_RTOL and _rel(W, jW) < PANEL_RTOL
    L64 = np.linalg.cholesky(A.astype(np.float64))
    W64 = np.linalg.inv(L64)
    for got_L, got_W in ((L, W), (jL, jW)):
        assert _rel(got_L, L64) < PANEL_RTOL and _rel(got_W, W64) < PANEL_RTOL
    assert np.all(np.triu(L, 1) == 0.0) and np.all(np.triu(W, 1) == 0.0)
    # the exported names are the same functions
    assert tops.cuda.chol_inv_panel is tchol.chol_inv_panel
    assert tops.cuda.chol_inv_panel_reference is tchol.chol_inv_panel_reference


def test_torch_chol_inv_panel_nan_on_indefinite(rng):
    A = _panel(rng, 96)
    A[40, 40] = -5.0
    L, W = tchol.chol_inv_panel(torch.from_numpy(A))
    d = torch.diagonal(L)
    assert torch.isfinite(d[:40]).all() and torch.isnan(d[40:]).all()
    assert torch.isnan(W[40:, :41]).all()


def test_torch_chol_inv_panel_refuses_bad_panels():
    with pytest.raises(ValueError, match="exceeds max 1024"):
        tchol.chol_inv_panel(torch.eye(1025))
    with pytest.raises(ValueError, match="square"):
        tchol.chol_inv_panel(torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="square"):
        tchol.chol_inv_panel(torch.zeros((2, 8, 8)))
    assert "chol_inv_panel" in kops.launch_counts


# ------------------------------------------------------------ estimators


def _estimators(**kw):
    return [GPRegressor(tops.RBF(), **kw), GPBinaryClassifier(tops.RBF(), **kw),
            GPMulticlassClassifier(tops.RBF(), 2, **kw)]


def test_torch_estimators_default_to_the_card(rng, monkeypatch):
    """An estimator built without ``device`` runs on the card: its device
    is cuda, and where CUDA is absent ``fit`` raises instead of running on
    the CPU. With ``device="cpu"`` it runs on the CPU."""
    x = rng.uniform(-3, 3, (30, 2))
    y = np.where(x[:, 0] > 0, 1.0, -1.0)
    labels = (x[:, 0] > 0).astype(np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model, target in zip(_estimators(), (y, y, labels)):
        assert model.device == torch.device("cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.fit(x, target)
        assert model.x_train is None
    for model, target in zip(_estimators(device="cpu"), (y, y, labels)):
        model.fit(torch.from_numpy(x), torch.from_numpy(target))
        assert model.device == torch.device("cpu") and model.x_train.device.type == "cpu"
        out = model.predict(torch.from_numpy(x[:5]))
        assert out.device.type == "cpu" and torch.isfinite(out.double()).all()
