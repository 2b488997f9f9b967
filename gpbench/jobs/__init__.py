"""The general generators of the benchmark's traffic, one module per kind:
a traffic file names its ``kind`` and the harness runs ``jobs/<kind>.py``'s
``Job`` with the configuration and the file's parameters.

A ``Job`` makes its inputs from the seed, builds the system under test
(``system="port"``) or the control in its place (``"control"``), and
offers ``setup()``, ``call()`` (one closed-loop call, finished on the
device; returns the units of work it completed), ``failed()``,
``products()`` (the shape of the window's K(x, x) V products),
``release()`` and ``check(limits)`` (the comparison with the plain
reference, run once the window has closed).
"""

import math
from typing import Dict, List, NamedTuple


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One ``Check`` per compared number; a number without a limit is an
    error of the cell's files, not a pass."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [Check(name, float(values[name]), float(limits[name])) for name in values]
