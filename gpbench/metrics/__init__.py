"""Per-layer metric readers, one file each, found by the metric's name:
``metrics/<name>.py``, or for a name split by traffic such as
``matvecs.train``, ``metrics/<name up to its first dot>.py``. Each holds
``read(readings) -> float | None``: None where it finds nothing to read,
and the harness then leaves the metric out of the line."""

from typing import NamedTuple, Optional


class Readings(NamedTuple):
    units: int  # steps or queries the window completed
    launches: dict  # the port's launch counts over the window, by kernel kind
    products: dict  # family, n, d, r of the window's K(x, x) V products
    trace: Optional[object]  # trace.Summary of a traced window, else None
