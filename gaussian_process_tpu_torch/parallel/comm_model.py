"""Analytic communication model of the distributed solves, and an audit
of the collectives they really issue (torch counterpart of
``parallel/comm_model.py``).

:func:`ici_comm_model` gives exact counts of the bytes each rank moves in
one distributed posterior (``parallel/cholesky.py``) and one
distributed-CG iteration (``parallel/cg.py``), and the time they would
take at an assumed link rate (model output, not a measurement).

Three repairs against the JAX model:
- the CG ring payload carries the RHS block's width r: a ring step moves
  the (m, d) coordinate block and the (m, r) vector block, where the JAX
  model counts one column (its ``:78``);
- the element size comes from the dtype, where the JAX model assumes 4
  bytes;
- the factor and the solves are priced in ``linalg.cholesky.solve_dtype``
  of the inputs' dtype (float64 for fp32 inputs), the dtype in which the
  port's posterior factors and solves, and so the dtype of their
  collectives.
The port's ring moves p - 1 blocks a matvec (none goes back to its
owner); the JAX ring moves p, so its model counts p ring steps an
iteration.

The audit (:func:`record_collectives`, :func:`audit_collectives`,
:func:`verify_posterior_model`, :func:`verify_cg_iteration_model`) checks
the model against what a rank sends. The JAX module reads the compiled
program's text for its collectives and infers how often each runs from
the ``while`` loops around it. Here a ``TorchDispatchMode`` sees every
``c10d`` operation that this rank executes, with its tensors, so a record
is one collective that ran: counts are real, and no loop depth is
inferred. Kinds come from the ``c10d`` operation, not from a backend's
profiler events (gloo runs a reduce-scatter as an all-reduce of the whole
input). The kernels of ``ops.cuda`` are launched through ``ctypes`` and
are not dispatcher operations, so the mode passes over them; every other
operation is handed on unchanged, so an audited run gives the same bits
as one without the mode (at some cost in host time: it is no run to
time). The first block in a process also imports torch's dispatch-mode
machinery, which takes seconds.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gaussian_process_tpu_torch.linalg.cholesky import solve_dtype


def ici_comm_model(p: int, n: int, t: int, d: int, *, r: int = 1, dtype="float32",
                   ici_link_gbps: float = 45.0) -> dict:
    """Predicted per-rank traffic of the distributed solves over p ranks of
    m = n / p rows, t test points, d input dimensions and a CG right-hand
    side of r columns (1 for the mean solver, 1 + t for
    ``make_posterior_cg``), for inputs of ``dtype``: the CG ring moves
    elements of ``dtype``, the factor and the solves elements of
    ``linalg.cholesky.solve_dtype(dtype)``.

    - panel Cholesky: each of the p panel steps all-reduces the (m, m)
      diagonal block and all-gathers an (m, m) block from every other rank;
    - solves: forward one (m, columns) all-reduce a step, backward two; the
      posterior runs a t-column forward (the variance) and a one-column
      forward and backward (alpha);
    - CG: each ring step moves the (m, d) and (m, r) blocks; the inner
      products' scalar all-reduces are left out.

    An all-reduce over a ring moves 2 (p - 1) / p bytes a payload byte; an
    all-gather (p - 1) blocks. Times divide by ``ici_link_gbps`` GB/s.
    """
    if p <= 1:
        return {
            "p": p, "chol_bytes_per_device": 0, "solve_bytes_per_device": 0,
            "cg_ring_bytes_per_device_per_step": 0, "cg_ring_steps_per_iter": 0,
            "cg_ring_bytes_per_device_per_iter": 0,
            "predicted_chol_comm_ms": 0.0, "predicted_solve_comm_ms": 0.0,
            "predicted_cg_iter_comm_ms": 0.0,
        }
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    B = dtype.itemsize
    Bf = solve_dtype(dtype).itemsize
    m = n // p
    ring = 2.0 * (p - 1) / p
    ag = float(p - 1)
    chol_bytes = p * (ring * m * m + ag * m * m) * Bf
    solve_bytes = (p * ring * m * t + 3 * p * ring * m * 1) * Bf
    step_bytes = m * (d + r) * B
    iter_bytes = (p - 1) * step_bytes
    bw = ici_link_gbps * 1e9
    return {
        "p": p,
        "chol_bytes_per_device": int(chol_bytes),
        "solve_bytes_per_device": int(solve_bytes),
        "cg_ring_bytes_per_device_per_step": int(step_bytes),
        "cg_ring_steps_per_iter": p - 1,
        "cg_ring_bytes_per_device_per_iter": int(iter_bytes),
        "predicted_chol_comm_ms": round(chol_bytes / bw * 1e3, 3),
        "predicted_solve_comm_ms": round(solve_bytes / bw * 1e3, 3),
        "predicted_cg_iter_comm_ms": round(iter_bytes / bw * 1e3, 4),
    }


# c10d operation -> the JAX audit's name of the collective. A ``recv`` is
# recorded but priced at nothing: its payload is counted once, at its send,
# as the JAX audit counts a collective-permute once.
_KINDS = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "send": "collective-permute",
    "recv_": "recv",
    "broadcast_": "broadcast",
}


def _flat_tensors(a) -> List[torch.Tensor]:
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (list, tuple)):
        return [t for x in a for t in _flat_tensors(x)]
    return []


class _Recorder(TorchDispatchMode):
    """Appends a record for every ``c10d`` operation it sees and runs the
    operation unchanged."""

    def __init__(self, records: List[dict]):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            op = func._schema.name.split("::")[-1]
            # the first argument is the result (out-of-place ops) or the
            # payload (in-place ones and point-to-point)
            ts = _flat_tensors(args[0]) if args else []
            self.records.append({
                "kind": _KINDS.get(op, "other"),
                "op": op,
                "out_bytes": sum(t.numel() * t.element_size() for t in ts),
                "shapes": [tuple(t.shape) for t in ts],
                "dtype": ts[0].dtype if ts else None,
                "device": ts[0].device.type if ts else None,
            })
        return func(*args, **kwargs)


@contextlib.contextmanager
def record_collectives():
    """Record the collectives this rank runs inside the block: yields a
    list that gets one dict per ``c10d`` operation, in order, with
    ``kind`` (the JAX audit's names: ``"all-reduce"``, ``"all-gather"``,
    ``"reduce-scatter"``, ``"collective-permute"`` for a send,
    ``"broadcast"``; ``"recv"`` for a receive; ``"other"`` for the rest,
    a barrier say), ``out_bytes`` (the result's bytes as HLO gives them:
    the gathered output of an all-gather, the payload of a send), ``shapes``
    and ``dtype`` of the tensors, the ``c10d`` ``op`` and the tensors'
    ``device`` type.

    Unlike the JAX records there is no ``computation`` or ``depth``: each
    record is a collective that executed, so a loop's collectives appear as
    often as they ran. Outside the block nothing is intercepted; inside it
    every operation runs as it would without it."""
    records: List[dict] = []
    with _Recorder(records):
        yield records


def audit_collectives(fn: Callable[..., Any], *args, **kwargs) -> Tuple[Any, List[dict]]:
    """Run ``fn(*args, **kwargs)`` once under :func:`record_collectives`;
    returns ``(its result, the records)``.

    The JAX function takes the compiled program's text, because a jitted
    program is there to be read before it runs. Eager PyTorch has no such
    program: its collectives exist only as they execute, so the audit
    takes the call that issues them."""
    with record_collectives() as records:
        out = fn(*args, **kwargs)
    return out, records


def _per_device_bytes(kind: str, out_bytes: int, p: int) -> float:
    """Bytes one rank moves for a collective of ``out_bytes`` over p ranks,
    at the JAX audit's ring costs."""
    if kind == "all-reduce":
        return 2.0 * (p - 1) / p * out_bytes
    if kind == "all-gather":
        return (p - 1) / p * out_bytes
    if kind == "reduce-scatter":
        return float(p - 1) * out_bytes  # the input is p outputs
    if kind == "recv":
        return 0.0  # counted at its send
    return float(out_bytes)  # send (collective-permute), broadcast, other


def _check(got: float, want: float, rel_tol: float, report: dict) -> None:
    # an explicit raise, so that ``python -O`` keeps the check
    if abs(got - want) > rel_tol * max(want, 1.0) + 1.0:
        raise AssertionError(report)


def verify_posterior_model(records: List[dict], p: int, n: int, t: int, d: int, *,
                           dtype=torch.float32, rel_tol: float = 1e-6) -> dict:
    """Check :func:`ici_comm_model`'s factor and solve bytes against the
    records of one ``parallel.distributed_posterior`` (or
    ``make_distributed_posterior``) call on inputs of ``dtype``.

    Classification is by payload shape, as in the JAX function: (m, m)
    all-reduces and (n, m) all-gathers are the factor's; (m, t) and (m, 1)
    all-reduces the solves'; everything else (the x gather, the LML's
    scalar and the (t,) reductions) is returned under ``other``, not
    hidden and not part of the model. Records are executed collectives, so
    no multiplicity is applied. Raises AssertionError, carrying the report,
    on a mismatch."""
    m = n // p
    model = ici_comm_model(p, n, t, d, r=1, dtype=dtype)
    chol = solve = other = 0.0
    for c in records:
        per_dev = _per_device_bytes(c["kind"], c["out_bytes"], p)
        shape = c["shapes"][0] if len(c["shapes"]) == 1 else None
        if c["kind"] == "all-reduce" and shape == (m, m):
            chol += per_dev
        elif c["kind"] == "all-gather" and shape == (n, m):
            chol += per_dev
        elif c["kind"] == "all-reduce" and shape in ((m, t), (m, 1)):
            solve += per_dev
        else:
            other += per_dev
    report = {
        "issued_chol_bytes_per_device": int(chol),
        "issued_solve_bytes_per_device": int(solve),
        "issued_other_bytes_per_device": int(other),
        "model_chol_bytes_per_device": model["chol_bytes_per_device"],
        "model_solve_bytes_per_device": model["solve_bytes_per_device"],
    }
    _check(chol, model["chol_bytes_per_device"], rel_tol, report)
    _check(solve, model["solve_bytes_per_device"], rel_tol, report)
    report["verified"] = True
    return report


def verify_cg_iteration_model(records: List[dict], p: int, n: int, d: int, *, r: int = 1,
                              iters: int, extra_matvecs: int = 0, dtype=torch.float32,
                              rel_tol: float = 1e-6) -> dict:
    """Check the CG ring's prediction against the records of one
    distributed CG solve on inputs of ``dtype`` that ran ``iters``
    iterations (the solver's returned count): the sends, summed and divided
    by the ring matvecs, must move ``ici_comm_model(...)
    ["cg_ring_bytes_per_device_per_iter"]``, (p - 1) m (d + r) elements a
    matvec. A solver that runs matvecs outside its iterations (an initial
    residual) names them in ``extra_matvecs``; the port's solvers run none.

    The all-reduces (the inner products, and the few outside the loop)
    are divided by ``iters`` and reported as excluded by the model, as the
    JAX function reports the loop's psums; all-gathers, broadcasts and the
    rest, the set-up's, are reported whole. Raises AssertionError, carrying
    the report, on a mismatch."""
    want = ici_comm_model(p, n, 1, d, r=r, dtype=dtype)["cg_ring_bytes_per_device_per_iter"]
    sends = psum = other = 0.0
    for c in records:
        if c["kind"] == "collective-permute":
            sends += c["out_bytes"]
        elif c["kind"] == "all-reduce":
            psum += _per_device_bytes(c["kind"], c["out_bytes"], p)
        else:
            other += _per_device_bytes(c["kind"], c["out_bytes"], p)
    matvecs = iters + extra_matvecs
    ring = sends / matvecs if matvecs else sends
    report = {
        "issued_cg_ring_bytes_per_device_per_iter": int(ring),
        "model_cg_ring_bytes_per_device_per_iter": int(want),
        "issued_per_iter_psum_bytes_excluded_by_model": int(psum / iters if iters else psum),
        "issued_other_bytes_per_device": int(other),
    }
    _check(ring, want, rel_tol, report)
    report["verified"] = True
    return report


__all__ = [
    "ici_comm_model",
    "record_collectives",
    "audit_collectives",
    "verify_posterior_model",
    "verify_cg_iteration_model",
]
