"""The yardstick's arithmetic: the roofline counts against hand counts, and
the trace readers on synthetic profiler traces."""

import json

import pytest

from gpbench import roofline, trace
from gpbench.metrics import Readings
from gpbench.spec import reader

US = 1e-6


def test_rbf_entry_counts_by_hand():
    assert roofline.entry_ops("rbf", 4) == 15
    assert roofline.entry_ops("rbf", 8) == 27
    with pytest.raises(ValueError):
        roofline.entry_ops("periodic", 1)


def test_symmetric_product_counts_by_hand():
    w = roofline.sym_matvec_work("rbf", 4, 2, 3)
    # 4 points: 10 distinct entries of 3*2 + 3 = 9 operations; 2 * 16 * 3
    # product operations; x (8 floats), V and the result (12 each), 4 bytes
    assert w == {"entry_ops": 90, "product_ops": 96, "bytes": 4 * (8 + 24)}


def test_least_time_is_the_largest_bound():
    peaks = {"fp32_flops": 10.0, "tf32_flops": 100.0, "hbm_bytes": 1000.0}
    assert roofline.least_seconds({"entry_ops": 50, "product_ops": 200, "bytes": 10},
                                  peaks) == 5.0
    assert roofline.least_seconds({"entry_ops": 5, "product_ops": 2000, "bytes": 10},
                                  peaks) == 20.0
    assert roofline.least_seconds({"entry_ops": 5, "product_ops": 20, "bytes": 10 ** 5},
                                  peaks) == 100.0


def test_the_cells_least_times():
    # reg100k at r = 9: the entries bound, 5242931200 x 15 / 67e12
    w = roofline.sym_matvec_work("rbf", 102400, 4, 9)
    assert roofline.least_seconds(w) == pytest.approx(102400 * 102401 / 2 * 15 / 67e12)
    # at r = 65 the product: 2 n^2 65 / 495e12
    w = roofline.sym_matvec_work("rbf", 102400, 4, 65)
    assert roofline.least_seconds(w) == pytest.approx(2 * 102400 ** 2 * 65 / 495e12)


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.summarize(trace.load(str(path)))


SYM = "void matvec_sym_kernel<16, 4, 1>(SymArgs)"
FULL = "void (anonymous namespace)::full_stage_kernel(float const*, float const*, int)"


def _window(tmp_path, library=True):
    ev = [_event(trace.WINDOW, "user_annotation", 1000, 1000),
          _event("aten::item", "cpu_op", 1500, 300),
          _event("cudaStreamSynchronize", "cuda_runtime", 1550, 100),
          _event("aten::mul", "cpu_op", 1900, 150),
          _event("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 1000, 100),
          _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1400, 50),
          _event("before the window", "kernel", 500, 100)]
    if library:
        ev += [_event(SYM, "kernel", 1100, 200), _event(FULL, "kernel", 1250, 100),
               _event("void matvec_bwd_sym_kernel<9>(BwdSymArgs)", "kernel", 1800, 100)]
    return _trace(tmp_path, ev)


def test_kernel_names():
    assert trace.kernel_name(SYM) == "matvec_sym_kernel"
    assert trace.kernel_name(FULL) == "full_stage_kernel"
    assert trace.kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"
    assert trace.kernel_name("void at::native::f<2>(int)") == "at::native::f"
    bwd = trace.kernel_name("void (anonymous namespace)::bwd_full_stage_kernel(float const*)")
    assert bwd == "bwd_full_stage_kernel" and bwd not in trace.FORWARD_SWEEP


def test_idle_share_and_breakdown(tmp_path):
    s = _window(tmp_path)
    # busy: [1000, 1350) and [1400, 1450) and [1800, 1900): 500 us of 1000
    assert s.window_s == pytest.approx(1000 * US)
    assert s.busy_s == pytest.approx(500 * US)
    assert s.library_launches == 3
    assert s.kernel_seconds["matvec_sym_kernel"] == pytest.approx(200 * US)
    assert s.device_ops[0] == ("matvec_sym_kernel", pytest.approx(200 * US))
    gaps = dict(s.idle_gaps)
    # gaps [1350, 1400): no host event; [1450, 1800): at its midpoint the
    # sync, inside aten::item; [1900, 2000): aten::mul
    assert gaps["cudaStreamSynchronize"] == pytest.approx(350 * US)
    assert gaps["aten::mul"] == pytest.approx(100 * US)
    assert gaps["(no host event)"] == pytest.approx(50 * US)
    readings = Readings(2, {"gram_matvec_sym": 2}, {"family": "rbf", "n": 100, "d": 4, "r": 9}, s)
    idle = reader("device_idle_pct.train")(readings)
    assert idle == pytest.approx(50.0)
    share = reader("sym_matvec_roofline_pct.train")(readings)
    least = 2 * roofline.least_seconds(roofline.sym_matvec_work("rbf", 100, 4, 9))
    assert share == pytest.approx(100 * least / (300 * US))
    assert reader("matvecs.train")(readings) == 1.0


def test_a_trace_without_the_library_reads_nothing_not_zero(tmp_path):
    s = _window(tmp_path, library=False)
    assert s.library_launches == 0 and s.busy_s > 0
    readings = Readings(2, {"gram_matvec_sym": 2}, {"family": "rbf", "n": 100, "d": 4, "r": 9}, s)
    assert reader("device_idle_pct.serve")(readings) is None
    assert reader("sym_matvec_roofline_pct.serve")(readings) is None
    assert reader("matvecs.serve")(readings) == 1.0
    assert reader("device_idle_pct.serve")(readings._replace(trace=None)) is None


def test_the_share_counts_the_same_work_whichever_sweep_ran(tmp_path):
    sym = _trace(tmp_path, [_event(trace.WINDOW, "user_annotation", 0, 1000),
                            _event(SYM, "kernel", 0, 400)])
    full = _trace(tmp_path, [_event(trace.WINDOW, "user_annotation", 0, 1000),
                             _event("void matvec_full_tc_kernel<4>(FullArgs)", "kernel", 0, 400)])
    shape = {"family": "rbf", "n": 1000, "d": 4, "r": 65}
    a = reader("sym_matvec_roofline_pct.serve")(
        Readings(1, {"gram_matvec_sym": 1}, shape, sym))
    b = reader("sym_matvec_roofline_pct.serve")(
        Readings(1, {"gram_matvec_full": 1}, shape, full))
    assert a == b and 0 < a <= 100


def test_a_trace_without_a_window_is_none(tmp_path):
    assert _trace(tmp_path, [_event(SYM, "kernel", 0, 10)]) is None


def test_union_of_intervals():
    total, merged = trace.union_seconds([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert total == 5 and merged == [[0, 3], [5, 7]]
