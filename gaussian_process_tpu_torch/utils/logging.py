"""Structured, rank-tagged JSONL logging (torch counterpart of
``utils/logging.py``).

Every event is one JSON line tagged with wall time, process rank and a
logical name, so convergence records (Newton error decay, BO best so far)
are machine-readable artifacts. Tensors and arrays become JSON through
``.tolist()``.

[ref: GP_binary_classification.py:117-121, tune_hyperparms_regression.py:
377-389, CO2_example.py:361-371: the reference's progress prints]
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any, Dict, Optional

from gaussian_process_tpu_torch.utils.checkpoint import _process_index


class JsonlLogger:
    """Append-only JSONL event logger.

    ``path=None`` logs to stderr. Each record:
    ``{"ts": ..., "rank": ..., "logger": ..., "event": ..., **fields}``.
    Ranks above 0 write ``<base>.rank<r><ext>`` beside ``path``.
    """

    def __init__(self, path: Optional[str] = None, *, name: str = "gp"):
        self.name = name
        self.rank = _process_index()
        self._own_file = path is not None
        if path is None:
            self._fh: IO[str] = sys.stderr
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            if self.rank > 0:
                base, ext = os.path.splitext(path)
                path = f"{base}.rank{self.rank}{ext}"
            self._fh = open(path, "a", buffering=1)
        self.path = path

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {"ts": round(time.time(), 6), "rank": self.rank, "logger": self.name,
                  "event": event}
        for k, v in fields.items():
            record[k] = _jsonable(v)
        self._fh.write(json.dumps(record) + "\n")
        return record

    def newton_step(self, iteration: int, error: float, **extra: Any) -> None:
        """[ref: GP_binary_classification.py:117 'iteration %d, error: %f']"""
        self.log("newton_step", iteration=iteration, error=error, **extra)

    def bo_step(self, iteration: int, best_lml: float, candidate, **extra: Any) -> None:
        """[ref: tune_hyperparms_regression.py:377-389]"""
        self.log("bo_step", iteration=iteration, best_lml=best_lml, candidate=candidate,
                 **extra)

    def close(self) -> None:
        if self._own_file:
            self._fh.close()

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v: Any) -> Any:
    """Tensors, arrays and NumPy scalars as JSON-native values."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def read_jsonl(path: str):
    """A JSONL log as a list of dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
