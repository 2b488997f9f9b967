"""Analytic communication model of the distributed solves (torch
counterpart of ``parallel/comm_model.py``'s ``ici_comm_model``).

Exact counts of the bytes each rank moves in one distributed posterior
(``parallel/cholesky.py``) and one distributed-CG iteration
(``parallel/cg.py``), and the time they would take at an assumed link
rate (model output, not a measurement).

Two repairs against the JAX model:
- the CG ring payload carries the RHS block's width r: a ring step moves
  the (m, d) coordinate block and the (m, r) vector block, where the JAX
  model counts one column (its ``:78``);
- the element size comes from the dtype, where the JAX model assumes 4
  bytes.
The port's ring moves p - 1 blocks a matvec (none goes back to its
owner); the JAX ring moves p, so its model counts p ring steps an
iteration.

The JAX module also audits the compiled HLO for its collectives
(``audit_collectives``, ``verify_posterior_model``,
``verify_cg_iteration_model``). Eager PyTorch compiles no program to read,
so that audit has no counterpart here.
"""

from __future__ import annotations

import torch


def _element_bytes(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def ici_comm_model(p: int, n: int, t: int, d: int, *, r: int = 1, dtype="float32",
                   ici_link_gbps: float = 45.0) -> dict:
    """Predicted per-rank traffic of the distributed solves over p ranks of
    m = n / p rows, t test points, d input dimensions and a CG right-hand
    side of r columns (1 for the mean solver, 1 + t for
    ``make_posterior_cg``), in elements of ``dtype``.

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
    B = _element_bytes(dtype)
    m = n // p
    ring = 2.0 * (p - 1) / p
    ag = float(p - 1)
    chol_bytes = p * (ring * m * m + ag * m * m) * B
    solve_bytes = (p * ring * m * t + 3 * p * ring * m * 1) * B
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
