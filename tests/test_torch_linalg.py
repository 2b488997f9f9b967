"""Parity of the port's linear algebra (``linalg/cholesky.py``,
``linalg/cg.py``, ``linalg/nystrom.py``) against the JAX package, in
float64 on the CPU. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.linalg import cg as jcg
from gaussian_process_tpu.linalg import cholesky as jchol
from gaussian_process_tpu.linalg import nystrom as jnys
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch.linalg import cg as tcg
from gaussian_process_tpu_torch.linalg import cholesky as tchol
from gaussian_process_tpu_torch.linalg import nystrom as tnys


def _spd(rng, n, min_eig):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([[min_eig], rng.uniform(0.5, 2.0, n - 1)])
    return (q * eig) @ q.T


@pytest.mark.parametrize(
    "min_eig,initial_jitter",
    [(0.3, 0.0), (0.3, 5e-4), (-3e-12, 0.0), (-2e-9, 1e-10)],
    ids=["spd", "spd_noise", "retry", "retry_after_noise"],
)
def test_safe_cholesky_matches_jax(rng, min_eig, initial_jitter):
    K = _spd(rng, 60, min_eig)
    want = jchol.safe_cholesky(jnp.asarray(K), initial_jitter=initial_jitter)
    got = tchol.safe_cholesky(torch.from_numpy(K), initial_jitter=initial_jitter)
    assert bool(got.ok) and bool(want.ok)
    # the same jitter is chosen from the same schedule
    np.testing.assert_allclose(float(got.jitter), float(want.jitter), rtol=1e-12)
    L = got.factor.numpy()
    np.testing.assert_allclose(L @ L.T, K + float(got.jitter) * np.eye(60), rtol=0, atol=1e-13)
    if min_eig < 0:
        assert float(got.jitter) > initial_jitter
    # after a retry the last pivot is ~sqrt(jitter) ~ 1e-6, and rounding in
    # either LAPACK call moves it by ~1e-10 absolute
    atol = 1e-9 if min_eig < 0 else 1e-12
    np.testing.assert_allclose(L, np.asarray(want.factor), rtol=1e-10, atol=atol)


def test_safe_cholesky_gives_up_like_jax(rng):
    K = _spd(rng, 30, -10.0)  # far from PSD: every retry fails
    want = jchol.safe_cholesky(jnp.asarray(K), max_attempts=3)
    got = tchol.safe_cholesky(torch.from_numpy(K), max_attempts=3)
    assert not bool(got.ok) and not bool(want.ok)
    assert bool(torch.isnan(got.factor).all())
    np.testing.assert_allclose(float(got.jitter), float(want.jitter), rtol=1e-12)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("rhs_cols", [None, 5])
def test_tri_solve_matches_jax(rng, trans, rhs_cols):
    L = np.linalg.cholesky(_spd(rng, 40, 0.5))
    b = rng.standard_normal(40 if rhs_cols is None else (40, rhs_cols))
    want = np.asarray(jchol.tri_solve(jnp.asarray(L), jnp.asarray(b), trans=trans))
    got = tchol.tri_solve(torch.from_numpy(L), torch.from_numpy(b), trans=trans).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_cholesky_solve_logdet_add_diagonal_match_jax(rng):
    K = _spd(rng, 40, 0.5)
    L = np.linalg.cholesky(K)
    b = rng.standard_normal((40, 3))
    tL = torch.from_numpy(L)
    np.testing.assert_allclose(
        tchol.cholesky_solve(tL, torch.from_numpy(b)).numpy(),
        np.asarray(jchol.cholesky_solve(jnp.asarray(L), jnp.asarray(b))),
        rtol=1e-12, atol=1e-14,
    )
    np.testing.assert_allclose(
        float(tchol.logdet_from_chol(tL)), float(jchol.logdet_from_chol(jnp.asarray(L))),
        rtol=1e-13,
    )
    np.testing.assert_allclose(
        tchol.add_diagonal(torch.from_numpy(K), 0.25).numpy(),
        np.asarray(jchol.add_diagonal(jnp.asarray(K), 0.25)),
        rtol=1e-15,
    )


def _rbf_system(rng, n=150, r=4, noise=0.3):
    x = rng.uniform(-5, 5, (n, 2))
    jp = {"sigma": 1.0, "lengthscale": 1.5}
    K = np.asarray(jops.gram(jops.RBF(), jp, x)) + noise * np.eye(n)
    return x, jp, K, rng.standard_normal((n, r))


@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_block_rhs_matches_jax(rng, jacobi):
    _, _, K, b = _rbf_system(rng)
    diag = np.diag(K).copy() if jacobi else None
    want = jcg.cg_solve(
        lambda v: jnp.asarray(K) @ v, jnp.asarray(b), tol=1e-10, max_iters=500,
        precond_diag=None if diag is None else jnp.asarray(diag),
    )
    tK = torch.from_numpy(K)
    got = tcg.cg_solve(
        lambda v: tK @ v, torch.from_numpy(b), tol=1e-10, max_iters=500,
        precond_diag=None if diag is None else torch.from_numpy(diag),
    )
    assert got.iters == int(want.iters) and 0 < got.iters < 500
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9, atol=1e-11)
    stop = 1e-10 * np.sqrt(np.max(np.sum(b * b, axis=0)))
    assert float(got.resnorm) <= stop and float(want.resnorm) <= stop
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(K, b), rtol=1e-6, atol=1e-8)


def test_cg_exact_resume_and_x0(rng):
    _, _, K, b = _rbf_system(rng)
    tK, tb = torch.from_numpy(K), torch.from_numpy(b)
    mv = lambda v: tK @ v
    inv_diag = torch.from_numpy(np.diag(K).copy())
    full = tcg.cg_solve(mv, tb, tol=1e-10, max_iters=500, precond_diag=inv_diag)
    part = tcg.cg_solve(mv, tb, tol=1e-10, max_iters=500, precond_diag=inv_diag,
                        max_new_iters=7)
    assert part.iters == 7
    resumed = tcg.cg_solve(mv, tb, tol=1e-10, max_iters=500, precond_diag=inv_diag,
                           init_state=part)
    assert resumed.iters == full.iters
    np.testing.assert_allclose(resumed.x.numpy(), full.x.numpy(), rtol=1e-12, atol=1e-14)
    # the same resume in the JAX package stops at the same iteration
    jpart = jcg.cg_solve(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), tol=1e-10,
                         max_iters=500, precond_diag=jnp.asarray(np.diag(K)),
                         max_new_iters=7)
    jres = jcg.cg_solve(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), tol=1e-10,
                        max_iters=500, precond_diag=jnp.asarray(np.diag(K)), init_state=jpart)
    assert int(jres.iters) == resumed.iters
    # a warm start from x0 converges to the same solution
    warm = tcg.cg_solve(mv, tb, tol=1e-10, max_iters=500, x0=part.x)
    np.testing.assert_allclose(warm.x.numpy(), full.x.numpy(), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("row_chunk", [None, 128], ids=["dense", "chunked"])
def test_nystrom_preconditioner_matches_jax(rng, row_chunk):
    x, jp, K, b = _rbf_system(rng, n=300, noise=1e-2)
    shift = 1e-2
    want = jnys.make_nystrom_preconditioner(
        jops.RBF(), jp, jnp.asarray(x), shift=shift, rank=40, row_chunk=row_chunk,
    )
    got = tnys.make_nystrom_preconditioner(
        convert.kernel_from_reference(jops.RBF()), convert.params_from_numpy(jp),
        torch.from_numpy(x), shift=shift, rank=40, row_chunk=row_chunk,
    )
    np.testing.assert_array_equal(got.landmarks.numpy(), np.asarray(want.landmarks))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.chol_G.numpy(), np.asarray(want.chol_G), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        got.apply(torch.from_numpy(b)).numpy(), np.asarray(want.apply(jnp.asarray(b))),
        rtol=1e-9, atol=1e-12,
    )
    np.testing.assert_allclose(
        got.apply(torch.from_numpy(b[:, 0])).numpy(), np.asarray(want.apply(jnp.asarray(b[:, 0]))),
        rtol=1e-9, atol=1e-12,
    )


def test_nystrom_random_landmarks_are_distinct(rng):
    x = torch.from_numpy(rng.uniform(-5, 5, (200, 2)))
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.5})
    gen = torch.Generator().manual_seed(3)
    U, G, idx = tnys.make_nystrom_factor(
        convert.kernel_from_reference(jops.RBF()), params, x, rank=30, generator=gen
    )
    assert len(set(idx.tolist())) == 30 and U.shape == (200, 30)
    np.testing.assert_allclose(G.numpy(), (U.T @ U).numpy(), rtol=1e-12, atol=1e-14)
