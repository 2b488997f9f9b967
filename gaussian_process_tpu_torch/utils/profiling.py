"""Timing and tracing (torch counterpart of ``utils/profiling.py``).

Work on card tensors is timed with CUDA events on the current stream, work
on CPU tensors with the host clock; which one is read from the tensors a
call returns (``Stopwatch``: the tensors passed as ``block``). PyTorch
returns before the card finishes, so a host clock alone would time the
enqueue.

The JAX module's ``enable_persistent_compile_cache`` has no counterpart:
XLA's compile cache has no meaning here. The port's kernels are built once
per hash of their sources into ``ops/cuda/_build/``
(``ops.cuda._build``), and nothing else is compiled.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

# Annotates a region in a torch.profiler trace (the JAX module's
# ``jax.named_scope``).
named_scope = torch.profiler.record_function


def _tensors(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _on_card(x: Any) -> bool:
    return any(t.is_cuda for t in _tensors(x))


class _Clock:
    """Seconds between :meth:`start` and :meth:`stop`, by CUDA events on the
    current stream where ``card`` (the stop synchronises on its event),
    else by the host clock."""

    def __init__(self, card: bool):
        self.card = card

    def start(self) -> None:
        if self.card:
            self._begin = torch.cuda.Event(enable_timing=True)
            self._begin.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._begin.elapsed_time(end) / 1e3
        return time.perf_counter() - self._t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    the card's where CUDA is available) and write it as a Chrome trace,
    ``<log_dir>/trace.json``. Yields the profiler, whose ``key_averages()``
    sum the time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    iters: int = 5,
    **kwargs: Any,
) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: ``warmup`` untimed calls (at least
    one: the first builds kernels and workspaces), then ``iters`` timed
    calls, each on CUDA events if the first call returned card tensors,
    else on the host clock. Returns mean/min/std seconds."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    clock = _Clock(_on_card(out))
    if clock.card:
        torch.cuda.synchronize()
    times: List[float] = []
    for _ in range(iters):
        clock.start()
        fn(*args, **kwargs)
        times.append(clock.stop())
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    return {"mean_s": mean, "min_s": min(times), "std_s": var ** 0.5, "iters": n}


def device_time_chained(
    step_fn: Callable[[Any], Any],
    init: Any,
    *,
    repeats: int = 8,
    readout: Optional[Callable[[Any], Any]] = None,
    trials: int = 1,
    trial_pause_s: float = 0.0,
) -> Dict[str, Any]:
    """Per-iteration time by the slope method: ``step_fn`` (carry -> carry,
    so no call can be skipped) is chained R and 2R times back to back, each
    chain timed whole (CUDA events for a card carry, else the host clock),
    and the time per step is (min T(2R) - min T(R)) / R, which cancels every
    fixed cost of a chain. ``trials`` independent pairs, ``trial_pause_s``
    apart; each pair's own slope is returned in ``trials_s`` for the
    spread. ``readout`` maps the final carry to what the chain ends with
    (default: the carry)."""
    if readout is None:
        readout = lambda c: c  # noqa: E731

    def chain(r: int):
        c = init
        for _ in range(r):
            c = step_fn(c)
        return readout(c)

    clock = _Clock(_on_card(chain(1)))

    def timed(r: int) -> float:
        if clock.card:
            torch.cuda.synchronize()
        clock.start()
        chain(r)
        return clock.stop()

    t1s: List[float] = []
    t2s: List[float] = []
    for k in range(max(trials, 1)):
        if k > 0 and trial_pause_s > 0:
            time.sleep(trial_pause_s)
        t1s.append(timed(repeats))
        t2s.append(timed(2 * repeats))
    per_iter = max((min(t2s) - min(t1s)) / repeats, 1e-9)
    return {
        "device_s": per_iter,
        "trials_s": [max((b - a) / repeats, 1e-9) for a, b in zip(t1s, t2s)],
        "t_r_s": min(t1s),
        "t_2r_s": min(t2s),
        "repeats": repeats,
        "fixed_overhead_s": max(min(t1s) - per_iter * repeats, 0.0),
    }


class Stopwatch:
    """Accumulating named phase timer. A phase whose ``block`` holds card
    tensors is timed on CUDA events around it (ending in a synchronise),
    any other on the host clock."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *, block: Optional[Any] = None):
        clock = _Clock(_on_card(block))
        clock.start()
        try:
            yield
        finally:
            dt = clock.stop()
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in self.totals
        }
