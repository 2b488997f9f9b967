"""The check that decides ``correct``: sound runs pass it, the TF32 control
in the program's place fails it, and so does the timed path with each
fault the cells can have, planted underneath the harness. Tiny cells on
the CPU (``conftest.py``); the limits of the card's cells were set from the
card's readings the same way (PERF.md)."""

import json

import pytest
import torch

from conftest import run_tiny

SEEDS = (3000000017, 3000000018, 3000000019)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(kind, seed):
    res = run_tiny(kind, seed)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails(kind, seed):
    res = run_tiny(kind, seed, system="control")
    assert not res["correct"], res["checks"]


def _train_fault(monkeypatch, fault):
    from gaussian_process_tpu_torch import opt

    original = opt.tune_large_scale
    calls = []

    def broken(kernel, params, x, y, **kw):
        calls.append(1)
        if fault == "unchanged":
            return original(kernel, params, x, y, **kw)._replace(params=params)
        if fault == "stale_after_first":
            # sound on set-up's call; every later call returns its params
            # unchanged, as a cached state would
            res = original(kernel, params, x, y, **kw)
            return res if len(calls) == 1 else res._replace(params=params)
        half = x.shape[0] // 2
        return original(kernel, params, x[:half], y[:half], **kw)

    monkeypatch.setattr(opt, "tune_large_scale", broken)


def _serve_fault(monkeypatch, fault):
    from gaussian_process_tpu_torch.gp import regression

    original = regression.posterior_cg

    def broken(kernel, params, x_train, y_train, x_test, **kw):
        if fault == "half_batch":
            half = x_train.shape[0] // 2
            return original(kernel, params, x_train[:half], y_train[:half], x_test, **kw)
        post = original(kernel, params, x_train, y_train, x_test, **kw)
        mean = post.mean.clone()
        mean[0] += 0.05  # one answer of the query altered where it is made
        return post._replace(mean=mean)

    monkeypatch.setattr(regression, "posterior_cg", broken)


@pytest.mark.parametrize("kind,fault", [("train", "unchanged"), ("train", "half_batch"),
                                        ("train", "stale_after_first"),
                                        ("serve", "answer"), ("serve", "half_batch")])
def test_each_fault_of_the_timed_path_fails(monkeypatch, kind, fault):
    if kind == "train":
        _train_fault(monkeypatch, fault)
    else:
        _serve_fault(monkeypatch, fault)
    res = run_tiny(kind)
    assert not res["correct"], res["checks"]


def test_a_state_left_unchanged_reads_one_on_the_change(monkeypatch):
    _train_fault(monkeypatch, "unchanged")
    res = run_tiny("train")
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0, abs=1e-6)


def test_a_window_call_is_followed_from_the_params_it_was_handed():
    res = run_tiny("train", min_calls=3)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3


def test_each_call_goes_on_from_the_last_params(monkeypatch):
    from gaussian_process_tpu_torch import opt

    original = opt.tune_large_scale
    handed, returned = [], []

    def spy(kernel, params, x, y, **kw):
        handed.append({k: float(v) for k, v in params.items()})
        res = original(kernel, params, x, y, **kw)
        returned.append({k: float(v) for k, v in res.params.items()})
        return res

    monkeypatch.setattr(opt, "tune_large_scale", spy)
    run_tiny("train", min_calls=3)
    assert handed[0] == {"sigma": pytest.approx(1.3), "lengthscale": pytest.approx(1.7)}
    assert len(handed) >= 4 and handed[1:] == returned[:-1]


@pytest.mark.parametrize("kind,cap", [("train", {"cg_max_iters": 2}),
                                      ("serve", {"max_iters": 2})])
def test_a_solve_that_reaches_its_cap_is_not_correct(kind, cap):
    res = run_tiny(kind, **cap)
    assert res["checks"]["capped_solves"]["value"] >= 1
    assert not res["correct"], res["checks"]


def test_traced_runs_check_the_same(kind):
    res = run_tiny(kind, traced=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the trace holds none of the library's kernels, so the
    # roofline and idle readers give nothing; the launch counter still reads
    assert not any(k.startswith(("sym_matvec_roofline_pct", "device_idle_pct"))
                   for k in res["metrics"])
    assert any(k.startswith("matvecs.") for k in res["metrics"])


def test_the_card_is_required_by_the_command(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from gpbench import harness

    rc = harness.main(["--workload", "reg100k.train8", "--seed", "5", "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
