"""Charging a traced window's device time and idle gaps to the port's spans.

The port opens a span (``utils.profiling.span`` of the port) at each layer
boundary of its hot path, named ``gp.<layer>.<what>``. Under torch.profiler
each is a ``user_annotation`` event, on the clock of the device's kernel,
memcpy and memset events. Two rules charge the window's work to them:

- device seconds: each device event, clipped to the window, goes to the
  innermost ``gp.*`` span open when the host launched it, the moment of the
  ``cuda_runtime`` or ``cuda_driver`` event of the same correlation;
- idle seconds: each idle gap of the window (split as ``trace.summarize``
  splits them) goes to the innermost ``gp.*`` span open at its midpoint.

In both, a span on any thread counts (autograd's backward runs on a thread
of its own), the innermost open span is the one that started latest, and
work under no span goes to ``NONE``.

The events come from a Chrome trace file (:func:`load`) or from a profiler
session's own events (:func:`from_profile`), the events its Chrome trace is
written from. A session exports its trace once, and the harness exports
it (``trace.summarize``) before the readers run; so a reader that finds no
charges in its readings takes them from the session of the traced
``harness.run`` call under way (:func:`of`).
"""

from __future__ import annotations

import heapq
import json
import sys
import time
import weakref
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

from gpbench import trace

PREFIX = "gp."
NONE = "(no span)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_LINKED = LAUNCH_CATS + trace.DEVICE_CATS  # the events that carry a correlation


class Event(NamedTuple):
    name: str
    cat: str
    ts: float  # microseconds
    dur: float
    tid: object
    correlation: Optional[int]  # a launch's and its device event's, else None


class Charges(NamedTuple):
    window_s: float
    library_launches: int  # device events of the port's library in the window
    device_s: Dict[str, float]  # device seconds in the window, by the span charged
    idle_s: Dict[str, float]  # idle seconds of the window, by the span charged
    counts: Dict[str, int]  # the gp.* spans that started in the window, by name


def load(path: str) -> List[Event]:
    """The complete events of a Chrome trace file."""
    with open(path) as f:
        raw = json.load(f)
    items = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [Event(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]),
                  float(e.get("dur", 0.0)), e.get("tid"), (e.get("args") or {}).get("correlation"))
            for e in items if e.get("ph") == "X" and "ts" in e]


def from_profile(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile`` session, as
    :func:`load` reads them from its Chrome trace, times counted from the
    first event so that microseconds keep their fraction. The session's
    events carry no category on every torch, so it is read from what they
    do carry: on the host, a user annotation, a runtime or driver call (it
    is linked to the op that made it) or an op; on the device, a user
    annotation or a kernel, copy or set (CUPTI names copies "Memcpy ..."
    and sets "Memset ...")."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    base = events[0].start_ns() if events else 0
    out = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            cat = ("user_annotation" if e.is_user_annotation()
                   else "cuda_runtime" if e.linked_correlation_id() > 0 else "cpu_op")
        elif e.is_user_annotation():
            cat = "gpu_user_annotation"
        else:
            cat = ("gpu_memcpy" if name.startswith("Memcpy")
                   else "gpu_memset" if name.startswith("Memset") else "kernel")
        out.append(Event(name, cat, (e.start_ns() - base) * 1e-3, e.duration_ns() * 1e-3,
                         e.start_thread_id(), e.correlation_id() if cat in _LINKED else None))
    return out


def _innermost(spans: List[Event], times: Iterable[float]) -> List[str]:
    """The name of the innermost span open at each of ``times`` (ascending),
    else NONE. ``spans`` are sorted by start; of two with one start, the
    one that ends first is inside the other."""
    active: list = []  # (-start, end, index): the latest start on top
    nxt = 0
    names = []
    for t in times:
        while nxt < len(spans) and spans[nxt].ts <= t:
            e = spans[nxt]
            heapq.heappush(active, (-e.ts, e.ts + e.dur, nxt))
            nxt += 1
        while active and active[0][1] <= t:
            heapq.heappop(active)
        names.append(spans[active[0][2]].name if active else NONE)
    return names


def charge(events: List[Event], window: str = trace.WINDOW) -> Optional[Charges]:
    """The window's device and idle seconds by span, or None where the
    events hold no window."""
    marks = [e for e in events if e.name == window and e.cat == "user_annotation"]
    if not marks:
        return None
    w0 = min(e.ts for e in marks)
    w1 = max(e.ts + e.dur for e in marks)
    spans = sorted((e for e in events
                    if e.cat == "user_annotation" and e.name.startswith(PREFIX)),
                   key=lambda e: (e.ts, e.ts + e.dur))
    device = [e for e in events if e.cat in trace.DEVICE_CATS and e.ts < w1 and e.ts + e.dur > w0]
    launched = {e.correlation: e.ts for e in events
                if e.cat in LAUNCH_CATS and e.correlation is not None}

    device_s: Dict[str, float] = defaultdict(float)
    timed = []  # (launch, seconds) of the device events whose launch the events hold
    for e in device:
        seconds = (min(e.ts + e.dur, w1) - max(e.ts, w0)) * 1e-6
        at = launched.get(e.correlation)
        if at is None:
            device_s[NONE] += seconds
        else:
            timed.append((at, seconds))
    timed.sort()
    for name, (_, seconds) in zip(_innermost(spans, (t for t, _ in timed)), timed):
        device_s[name] += seconds

    _, merged = trace.union_seconds((max(e.ts, w0), min(e.ts + e.dur, w1)) for e in device)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    idle_s: Dict[str, float] = defaultdict(float)
    for name, (g0, g1) in zip(_innermost(spans, (0.5 * (g0 + g1) for g0, g1 in gaps)), gaps):
        idle_s[name] += (g1 - g0) * 1e-6

    counts = Counter(e.name for e in spans if w0 <= e.ts < w1)
    library = sum(e.cat == "kernel" and trace.kernel_name(e.name) in trace.LIBRARY_KERNELS
                  for e in device)
    return Charges((w1 - w0) * 1e-6, library, dict(device_s), dict(idle_s), dict(counts))


# the charges of each session read so far, dropped with the session
_read: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _running_profile():
    """The profiler session of the traced ``harness.run`` call under way
    (its local ``prof``), else None."""
    from gpbench import harness

    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is harness.run.__code__:
            return frame.f_locals.get("prof")
        frame = frame.f_back
    return None


def of(readings) -> Optional[Charges]:
    """The charges of the traced window that ``readings`` describe: their
    ``spans`` where they carry them, else the running harness's session's
    (read once a session, and logged with the seconds the read took); None
    for an untraced run."""
    given = getattr(readings, "spans", None)
    if given is not None:
        return given
    prof = _running_profile()
    if prof is None:
        return None
    if prof not in _read:
        from gpbench import harness

        start = time.perf_counter()
        try:
            charges = charge(from_profile(prof))
        except AttributeError as err:  # a torch whose events lack what is read
            harness.log(f"the profiler's events cannot be read: {err}")
            charges = None
        _read[prof] = charges
        if charges is not None:
            # beside the trace's own window and busy seconds: the events agree
            t = getattr(readings, "trace", None)
            harness.log(f"spans read in {time.perf_counter() - start:.3f} s; window "
                        f"{charges.window_s!r} s (trace {getattr(t, 'window_s', None)!r}); "
                        f"device {sum(charges.device_s.values())!r} s (busy "
                        f"{getattr(t, 'busy_s', None)!r}); device s by span "
                        f"{json.dumps(charges.device_s)}; idle s by span "
                        f"{json.dumps(charges.idle_s)}; spans {json.dumps(charges.counts)}")
    return _read[prof]


def share(readings, seconds: str, names: Iterable[str]) -> Optional[float]:
    """100 x the window's ``seconds`` ("device_s" or "idle_s") charged to
    ``names`` over the window. None where there are no charges, the trace
    holds none of the port's library kernels, or none of ``names`` ran in
    the window."""
    c = of(readings)
    names = tuple(names)
    if (c is None or c.library_launches == 0 or c.window_s <= 0
            or not any(c.counts.get(n) for n in names)):
        return None
    by_span = getattr(c, seconds)
    return 100.0 * sum(by_span.get(n, 0.0) for n in names) / c.window_s
