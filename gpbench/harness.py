"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

- Set-up (``setup_s``) runs from the process's start to the first timed
  call: importing torch and the port, loading the CUDA library (building it
  on the first run in a checkout, into the port's ``_build/``; the build's
  own seconds are printed as ``build_s``), making the data from the seed
  and one warm-up call of the window's own shape.
- The window calls the job in a closed loop until ``--seconds`` have
  passed; the call under way then finishes and counts. The end-to-end
  metric is the window's seconds over the units (steps or queries) done.
- ``--trace 1`` runs the same window under torch.profiler and reports the
  per-layer metrics instead, with the device's busy seconds and a
  breakdown.
- Then the peak memory is read, the program's state is freed and the
  check runs: the job recomputes the window's answers with the float64
  reference and compares them under the cell's limits.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

from gpbench import spec
from gpbench import trace as _trace
from gpbench.metrics import Readings

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_process_tpu")


def log(*parts) -> None:
    print("gpbench:", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gpbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), t0)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _profile(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _summary(prof) -> Optional[_trace.Summary]:
    tmp = tempfile.mkdtemp(prefix="gpbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return _trace.summarize(_trace.load(path))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
        system: str = "port", warm: bool = True, min_calls: int = 1) -> Optional[dict]:
    """One run; the result line's object, or None where a forbidden module
    was loaded. ``system="control"`` puts the reference, in TF32, in the
    program's place (the control of the check). ``warm`` and ``min_calls``
    serve the readings (``gpbench.readings``): a serve job's warm-up query
    may be left out, and the window runs until both ``seconds`` and
    ``min_calls`` calls have passed (none where both are 0)."""
    import torch
    from gaussian_process_tpu_torch.ops.cuda import _build
    from gaussian_process_tpu_torch.ops.cuda import kernel_ops

    cuda = device.type == "cuda"
    phases = {"import": time.perf_counter() - t0}
    if cuda:
        if traced:
            # an empty session first: CUPTI starts before the CUDA context
            # and the port's library exist
            with _profile(device):
                pass
        torch.empty(1, device=device)
        phases["cuda"] = time.perf_counter() - t0
        _build.load()
        phases["library"] = time.perf_counter() - t0
    job = spec.job_class(cell.traffic["kind"])(cell.config, cell.traffic, seed, device,
                                                   system)
    job.setup(warm)
    setup_s = time.perf_counter() - t0
    phases["job"] = setup_s
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s (since the start: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"), build_s {_build.build_info.get('seconds')}")

    kernel_ops.reset_launch_counts()
    units = calls = 0
    with _profile(device) if traced else contextlib.nullcontext() as prof:
        with torch.profiler.record_function(_trace.WINDOW):
            start = time.perf_counter()
            while calls < min_calls or time.perf_counter() - start < seconds:
                units += job.call()
                calls += 1
            window_s = time.perf_counter() - start
    launches = dict(kernel_ops.launch_counts)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    read_start = time.perf_counter()
    summary = _summary(prof) if traced else None
    failed = job.failed()
    log(f"window {window_s:.3f} s, {calls} calls, {units} {job.unit}s, failed {failed}, "
        f"launches {json.dumps(launches)}"
        + (f", trace read in {time.perf_counter() - read_start:.3f} s" if traced else ""))
    if traced and summary is None:
        raise RuntimeError("the profiler's trace holds no window")

    job.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    checks, extra = job.check(cell.limits)
    check_s = time.perf_counter() - check_start
    log(f"check {check_s:.3f} s, detail", json.dumps(extra))
    card = _power_limit() if cuda else None

    readings = Readings(units, launches, job.products(), summary)
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s, job.end_to_end: window_s / units if units else None}
        for m in cell.end_to_end:
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if summary.library_launches == 0:
            log("the profile holds none of the port's library kernels: device_idle_pct and "
                "the roofline shares are not reported")
        for m in cell.per_layer:
            value = spec.reader(m["name"])(readings)
            if value is None or not math.isfinite(value):
                log(f"{m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(c.ok for c in checks) and failed == 0, "attempted": calls,
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result.update(setup_s=setup_s, build_s=_build.build_info.get("seconds"), check_s=check_s,
                  card=card, system=system)
    # a number that is not finite is written as text: JSON has no NaN
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                                 "limit": c.limit} for c in checks}

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    return result
