"""Charging device time and idle gaps to the port's spans (``gpbench/spans.py``)
and the five readers that read the charges, on a hand-built Chrome trace;
the same charges from a profiler session's own events; and traced tiny runs
through the harness on the CPU."""

import json
from types import SimpleNamespace

import pytest
import torch

from conftest import run_tiny
from gpbench import spans, trace
from gpbench.spec import reader

US = 1e-6
FULL = "void matvec_full_tc_kernel<4>(FullArgs)"
NEW = ["nystrom_build_pct", "nystrom_apply_pct", "cg_idle_pct", "matvec_idle_pct",
       "caller_idle_pct"]
OLD = ["sym_matvec_roofline_pct", "matvecs", "device_idle_pct"]


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
         "args": {"External id": 1}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _span(name, t0, t1, tid=1):
    return _x(name, "user_annotation", t0, t1 - t0, tid)


# a query of one block solve of two iterations, in microseconds: the window
# [1000, 2000) on thread 1, and a span on thread 2 (as autograd's backward
# thread opens one) that starts after every span of thread 1 it overlaps
SPANS = [_span("gp.posterior.query", 1000, 1990),
         _span("gp.solvers.nystrom_build", 1010, 1160),
         _span("gp.solvers.cg", 1200, 1980),
         _span("gp.solvers.nystrom_apply", 1230, 1260),
         _span("gp.solvers.cg_iteration", 1300, 1700),
         _span("gp.kernels.matvec", 1300, 1400),
         _span("gp.solvers.nystrom_apply", 1500, 1560),
         _span("gp.solvers.cg_iteration", 1700, 1975),
         _span("gp.kernels.matvec", 1700, 1800),
         _span("gp.kernels.matvec", 1850, 1900, tid=2)]
OTHERS = [_span(trace.WINDOW, 1000, 2000),
          _x("aten::mul", "cpu_op", 1330, 20),  # innermost at a gap's midpoint
          _x("cudaStreamSynchronize", "cuda_runtime", 1600, 90),
          # launches, each with its device event
          _x("cudaLaunchKernel", "cuda_runtime", 1020, 2, corr=1),
          _x("sm90_xmma_gemm_f64f64_f64f64_f64_tn_n", "kernel", 1030, 120, corr=1),
          _x("cudaLaunchKernel", "cuda_runtime", 1165, 2, corr=9),
          _x("void at::native::reduce_kernel<512>(int)", "kernel", 1170, 35, corr=9),
          _x("cudaLaunchKernel", "cuda_runtime", 1240, 2, corr=2),
          _x("trsm_left_kernel", "kernel", 1245, 35, corr=2),
          _x("cudaLaunchKernel", "cuda_runtime", 1390, 2, corr=3),
          _x(FULL, "kernel", 1400, 100, corr=3),
          _x("cudaMemcpyAsync", "cuda_runtime", 1510, 2, corr=4),
          _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1515, 45, corr=4),
          _x("cudaLaunchKernel", "cuda_runtime", 1790, 2, corr=5),
          _x(FULL, "kernel", 1950, 150, corr=5),  # runs past the window's end
          _x("cuLaunchKernel", "cuda_driver", 1860, 2, tid=2, corr=6),
          _x("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 1905, 35,
             corr=6),
          _x("cudaLaunchKernel", "cuda_runtime", 490, 2, corr=7),
          _x("before the window", "kernel", 500, 100, corr=7),
          _x("Memset (Device)", "gpu_memset", 1600, 10)]  # its launch is not in the trace


def _write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _readings(tmp_path, events):
    path = _write(tmp_path, events)
    return SimpleNamespace(units=1, launches={"gram_matvec_full": 2},
                           products={"family": "rbf", "n": 100, "d": 4, "r": 65},
                           trace=trace.summarize(trace.load(path)),
                           spans=spans.charge(spans.load(path)))


def test_the_charging_rules_by_hand(tmp_path):
    c = spans.charge(spans.load(_write(tmp_path, SPANS + OTHERS)))
    assert c.window_s == pytest.approx(1000 * US)
    assert c.library_launches == 2
    # each device event, clipped to the window, to the span open at its launch:
    # the build's GEMM; the query's reduce (the build closed at 1160); the two
    # applies' trsm and copy; two matvecs' sweeps (one clipped to 50 us) and
    # thread 2's elementwise kernel; the memset, whose launch is not there
    assert c.device_s == pytest.approx({
        "gp.solvers.nystrom_build": 120 * US, "gp.posterior.query": 35 * US,
        "gp.solvers.nystrom_apply": 80 * US, "gp.kernels.matvec": 185 * US,
        spans.NONE: 10 * US})
    # each idle gap to the span open at its midpoint: [1000, 1030) the build;
    # [1150, 1170) the query; [1205, 1245) the solve between its spans;
    # [1280, 1400) and [1610, 1905) matvecs (aten::mul at 1340 is no span);
    # [1500, 1515) an apply; [1560, 1600) and [1940, 1950) iterations
    assert c.idle_s == pytest.approx({
        "gp.solvers.nystrom_build": 30 * US, "gp.posterior.query": 20 * US,
        "gp.solvers.cg": 40 * US, "gp.kernels.matvec": 415 * US,
        "gp.solvers.nystrom_apply": 15 * US, "gp.solvers.cg_iteration": 50 * US})
    summary = trace.summarize(trace.load(_write(tmp_path, SPANS + OTHERS, "b.json")))
    assert sum(c.idle_s.values()) == pytest.approx(summary.window_s - summary.busy_s)
    assert c.counts == {"gp.posterior.query": 1, "gp.solvers.nystrom_build": 1,
                        "gp.solvers.cg": 1, "gp.solvers.nystrom_apply": 2,
                        "gp.solvers.cg_iteration": 2, "gp.kernels.matvec": 3}


def test_each_new_reader_by_hand(tmp_path):
    r = _readings(tmp_path, SPANS + OTHERS)
    expected = {"nystrom_build_pct": 12.0, "nystrom_apply_pct": 8.0, "cg_idle_pct": 9.0,
                "matvec_idle_pct": 41.5, "caller_idle_pct": 2.0}
    for name in NEW:
        for split in ("train", "serve"):
            assert reader(f"{name}.{split}")(r) == pytest.approx(expected[name])


def test_the_old_readers_read_the_same_with_the_spans(tmp_path):
    with_spans = _readings(tmp_path, SPANS + OTHERS)
    without = _readings(tmp_path, OTHERS)
    for name in OLD:
        for split in ("train", "serve"):
            a, b = reader(f"{name}.{split}")(with_spans), reader(f"{name}.{split}")(without)
            assert a is not None and a == b


def test_the_new_readers_read_nothing_without_their_spans(tmp_path):
    # the parent program opens no span; a trace without the library missed
    # the device's work; readings without charges are an untraced run
    no_spans = _readings(tmp_path, OTHERS)
    no_library = _readings(tmp_path, [e for e in SPANS + OTHERS if e["name"] != FULL])
    assert no_library.spans.library_launches == 0
    untraced = SimpleNamespace(**{**vars(no_spans), "spans": None, "trace": None})
    for name in NEW:
        for r in (no_spans, no_library, untraced):
            assert reader(f"{name}.serve")(r) is None
    # a training trace holds no query span, and the caller is its step
    step = [{**e, "name": "gp.training.step"} if e["name"] == "gp.posterior.query" else e
            for e in SPANS + OTHERS]
    assert reader("caller_idle_pct.train")(_readings(tmp_path, step)) == pytest.approx(2.0)


def test_a_session_and_its_chrome_trace_charge_alike(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(2):
                with torch.profiler.record_function("gp.solvers.cg_iteration"):
                    with torch.profiler.record_function("gp.kernels.matvec"):
                        torch.ones(64, 64) @ torch.ones(64, 64)
    from_session = spans.charge(spans.from_profile(prof))
    path = tmp_path / "session.json"
    prof.export_chrome_trace(str(path))
    from_file = spans.charge(spans.load(str(path)))
    assert from_session.counts == from_file.counts == {"gp.solvers.cg_iteration": 2,
                                                       "gp.kernels.matvec": 2}
    assert from_session.window_s == pytest.approx(from_file.window_s, abs=1e-8)
    assert set(from_session.idle_s) == set(from_file.idle_s)
    assert from_session.device_s == from_file.device_s == {}


@pytest.mark.parametrize("kind, root", [("train", "gp.training.step"),
                                        ("serve", "gp.posterior.query")])
def test_a_traced_tiny_run_reads_its_session_and_reports_no_new_metric(monkeypatch, kind,
                                                                       root):
    read = []
    original = spans.from_profile
    monkeypatch.setattr(spans, "from_profile", lambda prof: read.append(original(prof))
                        or read[-1])
    res = run_tiny(kind, traced=True)
    assert res["correct"], res["checks"]
    # no device here: nothing of the library ran, so no new metric is reported
    assert not any(k.startswith(tuple(NEW)) for k in res["metrics"])
    assert any(k.startswith("matvecs.") for k in res["metrics"])
    (events,) = read  # one read of the session, for all five readers
    charges = spans.charge(events)
    assert charges.counts[root] >= 1 and charges.library_launches == 0
    assert charges.counts["gp.solvers.cg_iteration"] >= 1


def test_the_untraced_line_keeps_its_keys(kind):
    res = run_tiny(kind)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "setup_s",
                        "build_s", "check_s", "card", "system", "checks"}
    assert set(res["metrics"]) == {"setup_s", "train_step_s" if kind == "train" else "query_s"}
