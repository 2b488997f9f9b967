"""Reading a torch.profiler trace of the measured window: which device
operations ran and for how long, how much of the window the device was
busy, and what the host was doing while it idled.

The trace is torch.profiler's Chrome trace (``export_chrome_trace``): a
list of events with a category (``cat``), a name, a start (``ts``) and a
duration (``dur``), both in microseconds on one clock for host and device.
The window is the host span ``WINDOW`` that the harness opens around the
measured calls. Device work is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event.
"""

from __future__ import annotations

import heapq
import json
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

WINDOW = "gpbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")

# the kernels of the port's CUDA library (gaussian_process_tpu_torch/csrc),
# by function name, and the port kernel each belongs to
LIBRARY_KERNELS = {
    "gram_kernel": "K1",
    "matvec_full_tc_kernel": "K2", "full_stage_kernel": "K2",
    "matvec_sym_kernel": "K3", "sym_finish_kernel": "K3",
    "matvec_bwd_full_kernel": "K4", "bwd_full_stage_kernel": "K4",
    "matvec_bwd_sym_kernel": "K4",
    "gram_bwd_kernel": "K5",
    "init_kernel": "K6", "diag_kernel": "K6", "panel_kernel": "K6", "update_kernel": "K6",
    "prescale_rows_kernel": "sliced layout",
}
# the kernels that compute K(x, x) V forward: K2's and K3's sweeps with their
# staging and finishing passes, and the sliced layout's prescaled copy of x
# (which K4's full sweep also launches where d is past its register width)
FORWARD_SWEEP = ("matvec_full_tc_kernel", "full_stage_kernel", "matvec_sym_kernel",
                 "sym_finish_kernel", "prescale_rows_kernel")

TOP = 10

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_:]*")


class Event(NamedTuple):
    name: str
    cat: str
    ts: float  # microseconds
    dur: float


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    library_launches: int
    kernel_seconds: Dict[str, float]  # by kernel_name()
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def kernel_name(name: str) -> str:
    """A kernel's function name, without return type, anonymous namespace,
    template arguments and parameters: "void (anonymous
    namespace)::full_stage_kernel(float const*, ...)" gives
    "full_stage_kernel". A name of another form is kept whole."""
    text = name.replace("(anonymous namespace)::", "")
    if text.startswith("void "):
        text = text[5:]
    head = re.split(r"[<(]", text, maxsplit=1)[0].strip()
    return head if _IDENT.fullmatch(head) else name


def load(path: str) -> List[Event]:
    with open(path) as f:
        raw = json.load(f)
    items = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [Event(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]),
                  float(e.get("dur", 0.0)))
            for e in items if e.get("ph") == "X" and "ts" in e]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, list]:
    """Total length (in the intervals' unit) of the union of [start, end)
    intervals, and the merged intervals in order."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), merged


def summarize(events: List[Event], window: str = WINDOW) -> Optional[Summary]:
    """The window's device work, or None where the trace has no window."""
    spans = [e for e in events if e.name == window and e.cat == "user_annotation"]
    if not spans:
        return None
    w0 = min(e.ts for e in spans)
    w1 = max(e.ts + e.dur for e in spans)
    device = [e for e in events if e.cat in DEVICE_CATS and e.ts < w1 and e.ts + e.dur > w0]
    busy, merged = union_seconds((max(e.ts, w0), min(e.ts + e.dur, w1)) for e in device)
    by_name: Dict[str, float] = {}
    launches = 0
    for e in device:
        key = kernel_name(e.name) if e.cat == "kernel" else e.name
        by_name[key] = by_name.get(key, 0.0) + e.dur * 1e-6
        launches += key in LIBRARY_KERNELS
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, library_launches=launches,
                   kernel_seconds=by_name, device_ops=ops,
                   idle_gaps=_idle_gaps(events, merged, w0, w1, window))


def _idle_gaps(events, merged, w0, w1, window) -> List[Tuple[str, float]]:
    """The window's idle gaps summed by what the host was doing in each: the
    innermost host event (the latest to start) under way at the gap's
    midpoint; the ten names with the most idle time."""
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    host = sorted((e for e in events if e.cat in HOST_CATS and e.name != window),
                  key=lambda e: e.ts)
    active: list = []  # (-start, end, name): the latest start on top
    nxt = 0
    by_name: Dict[str, float] = {}
    for g0, g1 in gaps:  # sorted, so their midpoints rise
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt].ts <= mid:
            e = host[nxt]
            heapq.heappush(active, (-e.ts, e.ts + e.dur, e.name))
            nxt += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
