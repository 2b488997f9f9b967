"""Parity of the port's segmented solvers (``gp.posterior_cg_segmented``,
``gp.laplace_fit_cg_segmented``) and of ``laplace_fit_cg``'s prebuilt
factor against the JAX package, in float64 on the CPU.

Tolerances: the segmented posterior's means and variances at rtol 1e-6 of
the JAX function's (both solve to tol 1e-8); a resume, in the same process
or through ``utils.checkpoint``, equal to the uninterrupted run; the
segmented Laplace mode within 1e-6 of the JAX function's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.utils import checkpoint

KW = dict(noise_variance=1e-2, tol=1e-8, segment_iters=5, test_chunk=8, precond_rank=128)
PARAMS = {"sigma": 1.0, "lengthscale": 1.0}


class _Stop(Exception):
    pass


def _problem(rng, n=600, m=20):
    x = rng.uniform(-5, 5, (n, 2))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.1 * rng.standard_normal(n)
    xs = rng.uniform(-5, 5, (m, 2))
    return x, y, xs


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _tparams():
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in PARAMS.items()}


def _stopped_snapshot(x, y, xs, after: int, **kw):
    """Run until the ``after``-th snapshot, then stop the run; return that
    snapshot."""
    snaps = []

    def cb(s):
        snaps.append(s)
        if len(snaps) == after:
            raise _Stop

    with pytest.raises(_Stop):
        tgp.posterior_cg_segmented(tops.RBF(), _tparams(), x, y, xs, snapshot_cb=cb, **kw)
    return snaps[-1]


def test_segmented_posterior_matches_jax(rng):
    x, y, xs = _problem(rng)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    want = jgp.posterior_cg_segmented(jops.RBF(), jp, x, y, xs, **KW)
    got = tgp.posterior_cg_segmented(tops.RBF(), _tparams(), *_t(x, y, xs), **KW)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-6, atol=1e-9)
    assert float(got.resnorm) < 1e-6


def _zeroed(tree):
    """A template shaped like ``tree`` holding zeros (what a fresh process
    builds before it restores)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeroed(c) for c in tree))
    if isinstance(tree, tuple):
        return tuple(_zeroed(c) for c in tree)
    return tree


@pytest.fixture(scope="module")
def uninterrupted():
    """One uninterrupted run and its snapshots."""
    x, y, xs = _t(*_problem(np.random.default_rng(0)))
    snaps = []
    ref = tgp.posterior_cg_segmented(tops.RBF(), _tparams(), x, y, xs,
                                     snapshot_cb=snaps.append, **KW)
    return (x, y, xs), ref, snaps


@pytest.mark.parametrize("through_disk", [False, True])
def test_segmented_snapshot_resume_equals_uninterrupted(uninterrupted, tmp_path, through_disk):
    """Stopped after the second segment of chunk 1 and resumed from that
    snapshot (kept in memory, or saved and restored by ``utils.checkpoint``
    into a zeroed template), the run ends where the uninterrupted one
    does, bit for bit."""
    (x, y, xs), ref, snaps = uninterrupted
    mid = [s for s in snaps if s.chunk == 1][1]
    assert mid.state.iters < [s for s in snaps if s.chunk == 1][-1].state.iters
    assert mid.alpha is not None and len(mid.means) == 1
    if through_disk:
        path = checkpoint.save(str(tmp_path / "seg"), mid)
        mid = checkpoint.restore(path, _zeroed(mid))
        assert isinstance(mid.state.iters, int) and isinstance(mid.worst_res, float)
    resumed = tgp.posterior_cg_segmented(tops.RBF(), _tparams(), x, y, xs, resume=mid, **KW)
    assert resumed.iters == ref.iters
    assert torch.equal(resumed.mean, ref.mean) and torch.equal(resumed.var, ref.var)


@pytest.mark.parametrize("field,value", [("n", 599), ("m", 19), ("test_chunk", 4)])
def test_segmented_resume_on_another_problem_raises(rng, field, value):
    x, y, xs = _t(*_problem(rng))
    snap = _stopped_snapshot(x, y, xs, after=2, **KW)
    with pytest.raises(ValueError, match="snapshot belongs"):
        tgp.posterior_cg_segmented(tops.RBF(), _tparams(), x, y, xs,
                                   resume=snap._replace(**{field: value}), **KW)


def _cls_problem(rng, n=300):
    x = rng.uniform(-3, 3, (n, 2))
    f_true = np.sin(x.sum(axis=1))
    y = np.where(f_true + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return x, y


def test_segmented_laplace_matches_jax_and_resumes(rng):
    x, y = _cls_problem(rng)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    want = jgp.laplace_fit_cg_segmented(jops.RBF(), jp, jnp.asarray(x), jnp.asarray(y),
                                        precond_rank=48, use_pallas=False, newton_per_call=2)
    tx, ty = _t(x, y)
    steps, fs = [], []
    got = tgp.laplace_fit_cg_segmented(tops.RBF(), _tparams(), tx, ty, precond_rank=48,
                                       use_kernel=False, newton_per_call=2,
                                       checkpoint_cb=lambda i, f: (steps.append(i), fs.append(f)))
    assert got.converged and got.iters == int(want.iters)
    assert steps == sorted(steps) and len(steps) >= 2
    np.testing.assert_allclose(got.f_mode.numpy(), np.asarray(want.f_mode), rtol=1e-6,
                               atol=1e-6)
    # resume_f continues from the first call's iterate to the same mode
    resumed = tgp.laplace_fit_cg_segmented(tops.RBF(), _tparams(), tx, ty, precond_rank=48,
                                           use_kernel=False, newton_per_call=2,
                                           resume_f=fs[0])
    assert steps[0] + resumed.iters == got.iters
    assert torch.equal(resumed.f_mode, got.f_mode)


def test_laplace_fit_cg_takes_a_prebuilt_factor(rng, monkeypatch):
    """The repaired ``precond_factor``: a fit on U built elsewhere gives the
    state of the fit that builds U itself, and no factor is built."""
    from gaussian_process_tpu_torch.linalg import nystrom

    x, y = _t(*_cls_problem(rng))
    own = tgp.laplace_fit_cg(tops.RBF(), _tparams(), x, y, precond_rank=48, use_kernel=False)

    def no_build(*args, **kwargs):
        raise AssertionError("a factor was built")

    monkeypatch.setattr(nystrom, "make_nystrom_factor", no_build)
    given = tgp.laplace_fit_cg(tops.RBF(), _tparams(), x, y, use_kernel=False,
                               precond_factor=own.U)
    assert given.U is own.U
    assert given.iters == own.iters and given.inner_iters == own.inner_iters
    for field in ("f_mode", "grad_at_mode", "sqrt_w"):
        assert torch.equal(getattr(given, field), getattr(own, field))
