"""A cell's parts, found by the names in ``BENCHMARK.json``: the
configuration file it names, ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the limits of its check), the job of the
traffic's ``kind`` (``jobs/<kind>.py``) and the readers of its per-layer
metrics (``metrics/``). Adding a cell, a configuration, a traffic mix or a
metric is adding files and entries."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, NamedTuple

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} {name!r}; known: {[e['name'] for e in entries]}")


def load_cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    bench = read_json(benchmark)
    cell = _by_name(bench["workloads"], name, "workload")
    config = read_json(benchmark.parent / _by_name(bench["configs"], cell["config"],
                                                   "configuration")["file"])
    traffic = read_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(ROOT / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(cell["chips"]), config, traffic, limits, e2e, per_layer)


def job_class(kind: str):
    return importlib.import_module(f"gpbench.jobs.{kind}").Job


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<metric>.py``, else of ``metrics/<metric up to
    its first dot>.py``."""
    for stem in (metric, metric.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            key = hashlib.sha256(str(path).encode()).hexdigest()[:12]
            spec = importlib.util.spec_from_file_location(f"gpbench_metric_{key}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise KeyError(f"no reader for the metric {metric!r} under {root / 'metrics'}")
