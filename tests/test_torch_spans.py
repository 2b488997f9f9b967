"""The port's spans (``utils.profiling.span``) on the CPU: off, they never
reach the profiler; under ``torch.profiler`` a posterior query, a training
step and a Laplace fit and prediction emit them once per unit of work,
nested as the layers are, and the answers are the same bits with the
profiler on and off."""

import json

import numpy as np
import torch

from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.models.estimators import (GPBinaryClassifier,
                                                          GPMulticlassClassifier)
from gaussian_process_tpu_torch.opt import large_scale as ls
from gaussian_process_tpu_torch.utils import profiling

NOISE = 1e-2
PARAMS = {"sigma": 1.3, "lengthscale": 1.7}


def _problem(n=300, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, (n, d))
    y = np.sin(0.9 * x.sum(1)) + 0.05 * rng.standard_normal(n)
    xs = rng.uniform(-5, 5, (7, d))
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xs)


def _query(x, y, xs):
    params = convert.params_from_numpy(PARAMS, dtype=torch.float64)
    return tgp.posterior_cg(tops.RBF(), params, x, y, xs, noise_variance=NOISE, tol=1e-8,
                            max_iters=500, preconditioner="nystrom", precond_rank=32,
                            use_kernel=True)


def _tune(x, y):
    params = convert.params_from_numpy(PARAMS, dtype=torch.float64)
    return ls.tune_large_scale(tops.RBF(), params, x, y, noise_variance=NOISE, steps=2,
                               num_probes=3, cg_tol=1e-6, precond_rank=32, seed=5,
                               use_kernel=True)


def _spans(tmp_path, fn):
    """fn's result and the gp.* spans it emitted, each as (name, start, end,
    parent), the parent being the innermost span that holds it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("gp.")), key=lambda s: (s[1], -s[2]))
    nested = []
    for i, (name, t0, t1) in enumerate(spans):
        holders = [s for s in spans[:i] if s[1] <= t0 and t1 <= s[2]]
        nested.append((name, t0, t1, holders[-1][0] if holders else None))
    return out, nested


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2] and s is not outer]


def test_span_off_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("gp.a") is profiling.span("gp.b")  # one shared no-op context
    with profiling.span("gp.a"):
        pass
    x, y, xs = _problem(n=120)
    post = _query(x, y, xs)
    assert post.iters > 0 and bool(torch.isfinite(post.mean).all())
    res = _tune(x, y)
    assert len(res.cg_iters) == 2


def test_a_query_emits_its_spans_once_per_unit(tmp_path):
    x, y, xs = _problem()
    post, spans = _spans(tmp_path, lambda: _query(x, y, xs))
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    (query,) = by["gp.posterior.query"]
    assert query[3] is None
    assert [s[3] for s in by["gp.solvers.nystrom_build"]] == ["gp.posterior.query"]
    (cg,) = by["gp.solvers.cg"]  # 7 points: one block solve
    assert cg[3] == "gp.posterior.query"
    # one span an iteration, each inside the solve
    assert len(by["gp.solvers.cg_iteration"]) == post.iters > 0
    assert all(s[3] == "gp.solvers.cg" for s in by["gp.solvers.cg_iteration"])
    # one matvec an iteration (x0 = 0: none before the loop), in its iteration
    assert len(by["gp.kernels.matvec"]) == post.iters
    assert all(s[3] == "gp.solvers.cg_iteration" for s in by["gp.kernels.matvec"])
    # one apply before the loop, then one an iteration
    applies = [s[3] for s in by["gp.solvers.nystrom_apply"]]
    assert applies == ["gp.solvers.cg"] + ["gp.solvers.cg_iteration"] * post.iters
    assert not _inside(spans, by["gp.solvers.nystrom_build"][0])
    assert set(by) == {"gp.posterior.query", "gp.solvers.nystrom_build", "gp.solvers.cg",
                       "gp.solvers.cg_iteration", "gp.kernels.matvec",
                       "gp.solvers.nystrom_apply"}


def test_a_training_step_holds_its_iterations(tmp_path):
    x, y, _ = _problem()
    res, spans = _spans(tmp_path, lambda: _tune(x, y))
    steps = [s for s in spans if s[0] == "gp.training.step"]
    assert len(steps) == 2 and all(s[3] is None for s in steps)
    for step, iters in zip(steps, res.cg_iters):
        inside = _inside(spans, step)
        names = [s[0] for s in inside]
        assert names.count("gp.solvers.cg_iteration") == iters > 0
        assert names.count("gp.solvers.nystrom_build") == 1
        assert names.count("gp.solvers.cg") == 1
        # the iterations' matvecs and the objective's, on [alpha | probes]
        assert names.count("gp.kernels.matvec") == iters + 1
        assert [s[3] for s in inside if s[0] == "gp.kernels.matvec"].count(
            "gp.training.step") == 1
    assert not [s for s in spans if s[0] != "gp.training.step" and s[3] is None]


def test_answers_are_the_same_bits_traced_and_not(tmp_path):
    x, y, xs = _problem()
    plain_post, plain_res = _query(x, y, xs), _tune(x, y)
    (post, res), _ = _spans(tmp_path, lambda: (_query(x, y, xs), _tune(x, y)))
    assert torch.equal(post.mean, plain_post.mean) and torch.equal(post.var, plain_post.var)
    assert post.iters == plain_post.iters
    assert torch.equal(res.lml_trace, plain_res.lml_trace)
    assert res.cg_iters == plain_res.cg_iters
    for k in PARAMS:
        assert torch.equal(res.params[k], plain_res.params[k])



def _classes(n=240, seed=3):
    x, _, xs = _problem(n=n, seed=seed)
    angle = torch.atan2(x[:, 1], x[:, 0])
    labels = torch.floor((angle + np.pi) / (2 * np.pi) * 3).long() % 3
    return x, labels, xs


def _multiclass(x, labels, xs):
    model = GPMulticlassClassifier(tops.RBF(), 3, dict(PARAMS), device="cpu").fit(
        x, labels, solver="cg", cg_tol=1e-8, precond_rank=32)
    return model.state, model.predict_proba(xs)


def _by_name(spans):
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    return by


def test_a_multiclass_fit_and_prediction_nest_their_spans(tmp_path):
    x, labels, xs = _classes()
    (st, _), spans = _spans(tmp_path, lambda: _multiclass(x, labels, xs))
    by = _by_name(spans)
    (fit,) = by["gp.laplace.fit"]
    (predict,) = by["gp.laplace.predict"]
    assert fit[3] is None and predict[3] is None and not _inside(spans, predict)
    # the fit's one Nyström factor, then one span a Newton step
    assert [s[3] for s in by["gp.solvers.nystrom_build"]] == ["gp.laplace.fit"]
    steps = by["gp.laplace.newton_step"]
    assert len(steps) == st.iters > 1 and all(s[3] == "gp.laplace.fit" for s in steps)
    for step, iters in zip(steps, st.cg_iters):
        inside = _inside(spans, step)
        children = [s[0] for s in inside if s[3] == "gp.laplace.newton_step"]
        assert children == ["gp.laplace.w_roots", "gp.laplace.precond_build", "gp.solvers.cg"]
        names = [s[0] for s in inside]
        assert names.count("gp.solvers.cg_iteration") == iters > 0
        # one apply before the loop, then one an iteration, inside it
        applies = [s[3] for s in inside if s[0] == "gp.solvers.nystrom_apply"]
        assert applies == ["gp.solvers.cg"] + ["gp.solvers.cg_iteration"] * iters
    assert set(by) == {"gp.laplace.fit", "gp.laplace.predict", "gp.laplace.newton_step",
                       "gp.laplace.w_roots", "gp.laplace.precond_build", "gp.solvers.cg",
                       "gp.solvers.cg_iteration", "gp.solvers.nystrom_apply",
                       "gp.solvers.nystrom_build"}


def test_a_binary_fit_and_prediction_nest_their_spans(tmp_path):
    x, labels, xs = _classes()
    y = 2.0 * (labels == 0).double() - 1.0

    def run():
        model = GPBinaryClassifier(tops.RBF(), dict(PARAMS), device="cpu").fit(
            x, y, solver="cg", cg_tol=1e-8, precond_rank=32)
        return model.state, model.predict_proba(xs)

    (st, _), spans = _spans(tmp_path, run)
    by = _by_name(spans)
    (fit,) = by["gp.laplace.fit"]
    (predict,) = by["gp.laplace.predict"]
    assert fit[3] is None and predict[3] is None
    assert [s[3] for s in by["gp.solvers.nystrom_build"]] == ["gp.laplace.fit"]
    assert [s[3] for s in by["gp.laplace.newton_step"]] == ["gp.laplace.fit"] * st.iters
    # each step builds its Woodbury and solves once; the prediction builds
    # one and solves its chunk
    assert [s[3] for s in by["gp.laplace.precond_build"]] == (
        ["gp.laplace.newton_step"] * st.iters + ["gp.laplace.predict"])
    assert [s[3] for s in by["gp.solvers.cg"]] == (
        ["gp.laplace.newton_step"] * st.iters + ["gp.laplace.predict"])


def test_laplace_answers_are_the_same_bits_traced_and_not(tmp_path):
    x, labels, xs = _classes()
    plain_st, plain_prob = _multiclass(x, labels, xs)
    (st, prob), _ = _spans(tmp_path, lambda: _multiclass(x, labels, xs))
    assert torch.equal(st.f_mode, plain_st.f_mode) and torch.equal(prob, plain_prob)
    assert st.cg_iters == plain_st.cg_iters and st.iters == plain_st.iters
