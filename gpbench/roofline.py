"""The card's peaks and the work of the benchmark's kernels, counted from the
function computed, whatever kernel computes it.

Peaks: NVIDIA's published figures for one H100 SXM (dense, no sparsity)
at its full power limit of 700 W; a run prints the card's own limit beside
its numbers.

A product K(x, x) V with x of n x d and V of n x r, K symmetric:
- entries: each distinct entry of K is evaluated once, n (n + 1) / 2 of
  them, at the family's operations an entry, charged at the float32 peak
  outside the tensor cores;
- product: 2 n^2 r operations, charged at the TF32 tensor-core peak;
- bytes: x and V read once and the n x r result written once, in float32.

The least time is the largest of the three, since they can overlap on
separate units. So a sweep rule that moves a product from the full sweep
(K2, which evaluates all n^2 entries) to the symmetric one (K3, half of
them) changes the time and not the count.
"""

from __future__ import annotations

PEAKS = {
    "fp32_flops": 67e12,  # float32, outside the tensor cores
    "tf32_flops": 495e12,  # TF32 tensor cores, dense
    "hbm_bytes": 3.35e12,  # HBM3 bandwidth, bytes a second
    "power_w": 700.0,  # the power limit these figures assume
}


def entry_ops(family: str, d: int) -> int:
    """Operations to evaluate one kernel entry from two points of d
    coordinates. RBF: d differences, d squares and d additions into the
    sum, the scale by -1/(2 l^2), the exp and the scale by sigma^2: 3d + 3,
    the count of the port's kernel table."""
    if family == "rbf":
        return 3 * d + 3
    raise ValueError(f"no operation count for the kernel family {family!r}")


def sym_matvec_work(family: str, n: int, d: int, r: int, itemsize: int = 4) -> dict:
    """The work of one K(x, x) V: entry operations, product operations and
    bytes, by the rules of the module docstring."""
    return {"entry_ops": n * (n + 1) // 2 * entry_ops(family, d),
            "product_ops": 2 * n * n * r,
            "bytes": itemsize * (n * d + 2 * n * r)}


def least_seconds(work: dict, peaks: dict = PEAKS) -> float:
    """The least time the card could take for ``work``."""
    return max(work["entry_ops"] / peaks["fp32_flops"],
               work["product_ops"] / peaks["tf32_flops"],
               work["bytes"] / peaks["hbm_bytes"])
