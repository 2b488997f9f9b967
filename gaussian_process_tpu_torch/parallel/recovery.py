"""Failure detection and elastic re-dispatch for sharded restarts (torch
counterpart of ``parallel/recovery.py``).

The unit of recovery is the hyperparameter-search candidate: every LML or
gradient-restart evaluation is stateless, so a lost shard (a dead host, a
lost card, a failed factorization) is evaluated again.

Detection:
- in the program: a failed factorization comes out as a non-finite LML
  (``linalg.safe_cholesky`` gives NaN past its jitter cap, never a wrong
  number);
- on the host: an exception from the sharded evaluation (a lost device, a
  broken connection) loses all of that attempt's candidates;
- across hosts: ``multihost.sync_hosts`` raises on every survivor when a
  process dies, and the caller comes back here with a mesh of survivors.

Re-dispatch is at-least-once: a candidate is a pure function of its
parameters, so evaluating it again is idempotent. Host code over a tree of
candidates (dicts, tuples, lists and NamedTuples whose leaves are tensors
or arrays with a leading batch dimension); the values are float64 NumPy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class RedispatchResult(NamedTuple):
    values: np.ndarray  # (batch,) evaluation results, NaN where unrecovered
    ok: np.ndarray  # (batch,) bool: candidate produced a finite result
    attempts: int  # dispatch rounds used
    redispatched: int  # total candidate re-evaluations performed


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, tuples, lists and
    NamedTuples (``None`` holds no leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, val) for val in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, val) for val in tree)
    return fn(tree)


def _first_leaf(tree):
    leaves = []
    _tree_map(leaves.append, tree)
    return leaves[0]


def _take(batch, idx: np.ndarray):
    return _tree_map(lambda leaf: _host(leaf)[idx], batch)


def _pad_to(batch, size: int):
    """Tile candidates up to ``size`` (sharded evaluations need full
    batches); the padding rows are duplicates whose results are
    discarded."""
    n = int(_first_leaf(batch).shape[0])
    reps = -(-size // n)

    def tile(leaf):
        arr = _host(leaf)
        return np.tile(arr, (reps,) + (1,) * (arr.ndim - 1))[:size]

    return _tree_map(tile, batch)


def run_with_redispatch(
    eval_batch: Callable,
    candidates,
    *,
    batch_granularity: int = 1,
    max_attempts: int = 3,
    inject_failure: Optional[Callable[[int, np.ndarray], np.ndarray]] = None,
    logger: Optional[Callable[[str], None]] = None,
) -> RedispatchResult:
    """Evaluate every candidate, re-dispatching the lost or failed ones.

    ``eval_batch(params_batch) -> (batch,)`` values (a tensor or an array),
    typically a ``make_sharded_lml`` closure. It receives the candidates'
    leaves as NumPy arrays, in batches whose size is a multiple of
    ``batch_granularity`` (the mesh's restart-axis size). An attempt whose
    ``eval_batch`` raises loses all of its candidates; whatever is never
    recovered comes back NaN with ``ok`` false. ``inject_failure(attempt,
    values) -> values`` is the tests' fault-injection hook, which may
    corrupt values to simulate lost shards.
    """
    log = logger or (lambda msg: None)
    n = int(_first_leaf(candidates).shape[0])
    values = np.full(n, np.nan, dtype=np.float64)
    pending = np.arange(n)
    attempts = 0
    redispatched = 0

    while pending.size and attempts < max_attempts:
        attempts += 1
        if attempts > 1:
            redispatched += int(pending.size)
        size = max(batch_granularity,
                   -(-pending.size // batch_granularity) * batch_granularity)
        batch = _pad_to(_take(candidates, pending), size)
        try:
            out = np.asarray(_host(eval_batch(batch)), dtype=np.float64)
        except Exception as exc:  # a lost device or connection: the whole attempt is lost
            log(f"redispatch attempt {attempts}: evaluation raised {exc!r}")
            continue
        if inject_failure is not None:
            out = inject_failure(attempts, out)
        out = out[: pending.size]
        finite = np.isfinite(out)
        values[pending[finite]] = out[finite]
        failed = pending[~finite]
        if failed.size:
            log(f"redispatch attempt {attempts}: {failed.size}/{pending.size} "
                f"candidates lost, requeueing")
        pending = failed

    return RedispatchResult(values=values, ok=np.isfinite(values), attempts=attempts,
                            redispatched=redispatched)
