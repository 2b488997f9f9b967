"""The port's re-dispatch loop (``parallel/recovery.py``), the twins of
``tests/test_recovery.py``: lost shards (NaN results) and whole-attempt
failures (raised exceptions) are detected and evaluated again, and the
results stay right."""

import collections

import numpy as np
import torch

from gaussian_process_tpu_torch.parallel import recovery


def _candidates(n):
    return {"lengthscale": np.linspace(0.5, 2.0, n), "sigma": np.ones(n)}


def _true_values(cand):
    return cand["lengthscale"] * 10.0  # a stand-in for LML(theta)


class TestRedispatch:
    def test_no_failures_single_attempt(self):
        cand = _candidates(6)
        res = recovery.run_with_redispatch(_true_values, cand)
        np.testing.assert_allclose(res.values, _true_values(cand))
        assert res.attempts == 1 and res.redispatched == 0 and res.ok.all()

    def test_nan_shards_are_redispatched(self):
        cand = _candidates(8)

        def inject(attempt, out):
            if attempt == 1:  # lose half the shards' results on the first try
                out = out.copy()
                out[::2] = np.nan
            return out

        res = recovery.run_with_redispatch(_true_values, cand, inject_failure=inject,
                                           max_attempts=3)
        np.testing.assert_allclose(res.values, _true_values(cand))
        assert res.ok.all()
        assert res.attempts == 2
        assert res.redispatched == 4  # the four lost candidates ran again

    def test_raising_attempt_is_retried(self):
        cand = _candidates(4)
        calls = {"n": 0}
        logged = []

        def flaky(batch):
            calls["n"] += 1
            if calls["n"] == 1:  # a lost device on attempt 1
                raise RuntimeError("device lost")
            return torch.as_tensor(_true_values(batch))  # a tensor comes back as float64

        res = recovery.run_with_redispatch(flaky, cand, max_attempts=3, logger=logged.append)
        np.testing.assert_allclose(res.values, _true_values(cand))
        assert res.ok.all() and res.attempts == 2 and res.redispatched == 4
        assert res.values.dtype == np.float64
        assert "device lost" in logged[0]

    def test_unrecoverable_candidate_reported(self):
        cand = _candidates(4)

        def always_nan_first(batch):
            out = np.asarray(_true_values(batch)).copy()
            out[0] = np.nan  # index 0 of whatever batch is pending
            return out

        res = recovery.run_with_redispatch(always_nan_first, cand, max_attempts=2)
        assert not res.ok.all() and np.isnan(res.values[~res.ok]).all()
        assert res.ok.sum() >= 2

    def test_batch_granularity_padding(self):
        Cand = collections.namedtuple("Cand", "lengthscale sigma")
        cand = Cand(torch.linspace(0.5, 2.0, 5, dtype=torch.float64),
                    torch.ones(5, dtype=torch.float64))
        sizes = []

        def eval_fn(batch):
            n = len(batch.lengthscale)
            sizes.append(n)
            assert n % 4 == 0, n  # the mesh axis's granularity respected
            assert isinstance(batch, Cand) and isinstance(batch.sigma, np.ndarray)
            return batch.lengthscale * 10.0

        res = recovery.run_with_redispatch(eval_fn, cand, batch_granularity=4)
        np.testing.assert_allclose(res.values, cand.lengthscale.numpy() * 10.0)
        assert sizes == [8]

    def test_sharded_lml_integration(self):
        """End to end: re-dispatch around the port's sharded LML on a
        one-rank gloo mesh, against the JAX package's LML."""
        import jax.numpy as jnp
        import torch.distributed as dist

        from gaussian_process_tpu import gp as jgp
        from gaussian_process_tpu import ops as jops
        from gaussian_process_tpu_torch import ops, parallel

        rng = np.random.default_rng(0)
        x = rng.uniform(-5, 5, (16, 2))
        y = np.sin(x.sum(axis=1))
        cand = {"sigma": np.ones(8), "lengthscale": np.linspace(0.5, 2.0, 8)}

        def inject(attempt, out):
            if attempt == 1:
                out = out.copy()
                out[3] = np.nan  # one lost shard
            return out

        def redispatch():
            # the mesh goes when this returns, before its group
            fn = parallel.make_sharded_lml(ops.RBF(), mesh=parallel.make_mesh(device="cpu"))
            return recovery.run_with_redispatch(
                lambda b: fn({k: torch.as_tensor(v) for k, v in b.items()},
                             torch.as_tensor(x), torch.as_tensor(y)),
                cand, batch_granularity=4, inject_failure=inject)

        assert not dist.is_initialized()
        try:
            res = redispatch()
        finally:
            dist.destroy_process_group()
        assert res.ok.all() and res.attempts == 2 and res.redispatched == 1
        for i in range(8):
            p = {k: jnp.asarray(v[i]) for k, v in cand.items()}
            want = float(jgp.log_marginal_likelihood(jops.RBF(), p, jnp.asarray(x),
                                                     jnp.asarray(y)))
            assert abs(res.values[i] - want) / abs(want) < 1e-8
