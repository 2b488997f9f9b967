"""The classify traffic (``jobs/classify.py``) and its cell: a tiny cell on
the CPU through the harness, where the port fits with dense K products and
the reference (``reference/multiclass.py``) with its own; the check passes
sound runs and fails the TF32 control and each fault planted under the
estimator; the cells and the ``.fit`` metrics load by name; the three
Laplace readers on hand-built charges."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from gpbench import harness, spans, spec
from gpbench.spec import reader

# n 800 on [-2, 2]^2 at rank 64: the port's Newton loop stops far under its
# tolerance here, so its gaps sit well apart from the control's
TINY = {"name": "tinycls", "n": 800, "d": 2, "dtype": "float32", "num_classes": 3,
        "kernel": {"family": "rbf", "sigma": 1.0, "lengthscale": 1.0}, "rank": 64,
        "data": {"inputs": "uniform", "half_width": 2.0, "labels": "angle", "seed": 800},
        "reference": {"newton_tol": 1e-10, "newton_max_iters": 100, "cg_tol": 1e-10,
                      "cg_max_iters": 1000, "rank": 800, "landmark_seed": 1024}}
# set from CPU readings by the rule of the tiny cells (conftest.py): over 4
# seeds the program read mode_err 4.4e-6, prob_err up to 1.8e-6 and
# predict_err up to 4.7e-7, the TF32 control at least 6.1e-3, 6.5e-3 and
# 5.7e-4
TINY_LIMITS = {"mode_err": 5e-5, "prob_err": 2e-5, "predict_err": 5e-6, "capped_solves": 0}
SEEDS = (3000000017, 4000000003)
CELLS = ("multiclass100k.fit2048", "reg100k.serve8")
FIT = ["sym_matvec_roofline_pct", "matvecs", "device_idle_pct", "nystrom_build_pct",
       "nystrom_apply_pct", "cg_idle_pct", "matvec_idle_pct", "w_roots_pct",
       "precond_build_pct", "laplace_idle_pct"]


def tiny_cell(**traffic_changes) -> spec.Cell:
    bench = spec.read_json(spec.BENCHMARK)
    traffic = {**spec.read_json(spec.ROOT / "traffic" / "fit2048.json"), "solver": "cg",
               "m": 64, "pool": 2, **traffic_changes}
    e2e = [m for m in bench["end_to_end"] if m["name"] in ("setup_s", "train_step_s")]
    per_layer = [m for m in bench["per_layer"] if m["name"].endswith(".fit")]
    return spec.Cell("tiny.fit2048", 1, TINY, traffic, TINY_LIMITS, e2e, per_layer)


def run_tiny(seed: int = SEEDS[0], *, system: str = "port", traced: bool = False,
             min_calls: int = 2, **traffic_changes) -> dict:
    torch.set_num_threads(2)
    return harness.run(tiny_cell(**traffic_changes), seed, 0.0, traced, torch.device("cpu"),
                       time.perf_counter(), system=system, min_calls=min_calls)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(seed):
    res = run_tiny(seed)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 2
    assert res["metrics"]["train_step_s"]["value"] > 0
    json.dumps(res)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails(seed):
    res = run_tiny(seed, system="control")
    assert not res["correct"], res["checks"]


def _fault(monkeypatch, fault):
    from gaussian_process_tpu_torch.gp import multiclass

    fit, predict = multiclass.laplace_fit_multiclass_cg, multiclass.predict_multiclass_cg

    def broken_fit(*args, **kw):
        st = fit(*args, **kw)
        if fault == "mode":
            f = st.f_mode.clone()
            f[0, 0] += 0.05  # one latent value altered where it is made
            return st._replace(f_mode=f)
        return st

    def broken_predict(*args, **kw):
        pred = predict(*args, **kw)
        if fault == "prob":
            prob = pred.prob.clone()
            prob[0, 0] += 0.01  # one probability altered where it is made
            return pred._replace(prob=prob)
        return pred

    monkeypatch.setattr(multiclass, "laplace_fit_multiclass_cg", broken_fit)
    monkeypatch.setattr(multiclass, "predict_multiclass_cg", broken_predict)


@pytest.mark.parametrize("fault", ["mode", "prob"])
def test_an_altered_answer_fails(monkeypatch, fault):
    _fault(monkeypatch, fault)
    res = run_tiny()
    assert not res["correct"], res["checks"]
    assert res["checks"][f"{fault}_err"]["value"] > TINY_LIMITS[f"{fault}_err"]
    # an altered probability is a fault of the prediction path, which the
    # program's own mode checks whatever the gap of the mode
    failing = {"mode": "mode_err", "prob": "predict_err"}[fault]
    assert res["checks"][failing]["value"] > TINY_LIMITS[failing]


def test_a_solve_at_its_cap_fails():
    res = run_tiny(cg_max_iters=1)
    assert res["checks"]["capped_solves"]["value"] >= 1
    assert not res["correct"], res["checks"]


def test_an_unconverged_fit_fails():
    res = run_tiny(max_iters=1)
    assert res["failed"] == 2 and not res["correct"], res["checks"]  # the window's two


def test_the_window_call_is_checked_on_its_own_test_set(monkeypatch):
    from gpbench.jobs import classify

    seen = []
    original = classify.Job.check

    def spy(self, limits):
        checks, extra = original(self, limits)
        seen.append(extra)
        return checks, extra

    monkeypatch.setattr(classify.Job, "check", spy)
    run_tiny(min_calls=3)
    (extra,) = seen
    assert extra["call"] in (1, 2, 3) and extra["test_set"] == extra["call"] % 2
    assert extra["reference_steps"] >= 1


def test_a_traced_tiny_run_checks_the_same():
    res = run_tiny(traced=True)
    assert res["correct"], res["checks"]
    # no device here: the library's kernels are absent, so the span readers
    # and the roofline give nothing; the launch counter still reads
    assert set(res["metrics"]) == {"matvecs.fit"}


@pytest.mark.parametrize("name", CELLS)
def test_the_new_cells_load_by_name(name):
    cell = spec.load_cell(name)
    job = spec.job_class(cell.traffic["kind"])
    assert job.end_to_end in [m["name"] for m in cell.end_to_end]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", job.end_to_end}
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
    split = {"classify": "fit", "serve": "serve"}[cell.traffic["kind"]]
    assert {m["name"] for m in cell.per_layer} == (
        {f"{n}.fit" for n in FIT} if split == "fit" else
        {m["name"] for m in spec.load_cell("reg100k.serve64").per_layer})
    assert cell.limits["capped_solves"] == 0


def test_the_classification_cell_states_its_deployment():
    cell = spec.load_cell("multiclass100k.fit2048")
    c, t = cell.config, cell.traffic
    assert (c["n"], c["d"], c["num_classes"], c["rank"], c["dtype"]) == (102400, 2, 3, 256,
                                                                         "float32")
    assert c["kernel"] == {"family": "rbf", "sigma": 1.0, "lengthscale": 1.0}
    assert (t["kind"], t["solver"], t["m"], t["cg_tol"], t["cg_max_iters"]) == (
        "classify", "auto", 2048, 1e-4, 200)
    # the prediction path's limit catches a probability altered by 0.01
    assert cell.limits["predict_err"] < 0.01 and set(cell.limits) == {
        "mode_err", "prob_err", "predict_err", "capped_solves"}
    # the reference converges 100 times tighter than the program on both counts
    r, eps32 = c["reference"], torch.finfo(torch.float32).eps
    assert r["newton_tol"] * 100 <= max(10 * eps32 ** 0.5, t["cg_tol"])
    assert r["cg_tol"] * 100 <= t["cg_tol"]


def _charges(**spans_started):
    # a window of 1 s in which the library ran: device and idle seconds by span
    return spans.Charges(1.0, 3, {"gp.laplace.w_roots": 0.12, "gp.laplace.precond_build": 0.05,
                                  "gp.kernels.matvec": 0.4},
                         {"gp.laplace.newton_step": 0.02, "gp.laplace.fit": 0.01,
                          "gp.laplace.predict": 0.005, "gp.solvers.cg_iteration": 0.3},
                         spans_started)


@pytest.mark.parametrize("name, value", [("w_roots_pct", 12.0), ("precond_build_pct", 5.0),
                                         ("laplace_idle_pct", 3.5)])
def test_the_laplace_readers_by_hand(name, value):
    started = {"gp.laplace.w_roots": 7, "gp.laplace.precond_build": 7, "gp.laplace.fit": 1,
               "gp.laplace.newton_step": 7, "gp.laplace.predict": 1}
    r = SimpleNamespace(spans=_charges(**started), trace=None)
    assert reader(f"{name}.fit")(r) == pytest.approx(value)


@pytest.mark.parametrize("name", ["w_roots_pct", "precond_build_pct", "laplace_idle_pct"])
def test_the_laplace_readers_read_nothing_without_their_spans(name):
    # the parent opens no Laplace span; a trace without the library missed
    # the device's work; readings without charges are an untraced run
    no_spans = SimpleNamespace(spans=_charges(**{"gp.kernels.matvec": 3}), trace=None)
    no_library = SimpleNamespace(spans=_charges(**{"gp.laplace.w_roots": 7,
                                                   "gp.laplace.precond_build": 7,
                                                   "gp.laplace.fit": 1})._replace(
        library_launches=0), trace=None)
    untraced = SimpleNamespace(spans=None, trace=None)
    for r in (no_spans, no_library, untraced):
        assert reader(f"{name}.fit")(r) is None
