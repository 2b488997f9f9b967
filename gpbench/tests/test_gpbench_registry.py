"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, limits, job and metric readers load by name, the file keeps the
benchmark contract's form, and a new cell, configuration, traffic mix and
metric run from new files and entries alone."""

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT, TINY
from gpbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.read_json(spec.BENCHMARK)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_file_has_the_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpbench"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60
    # seconds, 180 seconds a cell to compile, 1200 spare, within 43200
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("gpbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    job = spec.job_class(cell.traffic["kind"])
    assert job.end_to_end in reported
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(spec.reader(m["name"]))
    # a gap's limit lies above 0; a count that has to be exact has the limit 0
    assert cell.limits.pop("capped_solves") == 0
    assert set(cell.limits) and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    assert cell.config["name"] == next(w for w in BENCH["workloads"] if w["name"] == name)["config"]
    assert cell.config["rank"] == min(2048, max(512, cell.config["n"] // 50))


def test_reader_lookup_takes_the_full_name_before_the_base_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "foo.py").write_text("def read(r):\n    return 1.0\n")
    (tmp_path / "metrics" / "foo.serve.py").write_text("def read(r):\n    return 2.0\n")
    assert spec.reader("foo.serve", tmp_path)(None) == 2.0
    assert spec.reader("foo.train", tmp_path)(None) == 1.0
    with pytest.raises(KeyError):
        spec.reader("bar.train", tmp_path)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "gpbench")
    bench = json.loads(json.dumps(BENCH))
    gp = tmp_path / "gpbench"
    (gp / "configs" / "tiny2.json").write_text(json.dumps({**TINY, "name": "tiny2"}))
    (gp / "traffic" / "serve8.json").write_text(json.dumps(
        {"kind": "serve", "loop": "closed", "m": 8, "tol": 1e-3, "max_iters": 1000,
         "check_queries": 2}))
    (gp / "limits" / "tiny2.serve8.json").write_text(json.dumps(
        {"mean_err": 1e-2, "var_err": 1e-3, "capped_solves": 0}))
    (gp / "metrics" / "queries_done.py").write_text(
        '"""Queries the window completed."""\n\n\ndef read(r):\n    return float(r.units)\n')
    bench["configs"].append({"name": "tiny2", "source": "a test", "file":
                             "gpbench/configs/tiny2.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny2.serve8", "config": "tiny2", "traffic": "serve8",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "query_s")["workloads"].append(
        "tiny2.serve8")
    bench["per_layer"].append({"name": "queries_done.serve", "unit": "queries", "better":
                               "higher", "source": "host_clock", "layer": "facade",
                               "moves": "query_s", "workloads": ["tiny2.serve8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        import torch
        torch.set_num_threads(2)
        import gpbench
        from gpbench import harness, spec
        assert gpbench.__file__.startswith({str(tmp_path)!r}), gpbench.__file__
        cell = spec.load_cell("tiny2.serve8")
        for traced in (False, True):
            res = harness.run(cell, 3000000021, 0.2, traced, torch.device("cpu"),
                              time.perf_counter())
            print(json.dumps(res))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    timed, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert timed["correct"] and traced["correct"]
    assert set(timed["metrics"]) == {"setup_s", "query_s"}
    assert traced["metrics"]["queries_done.serve"]["value"] >= 1
    assert "matvecs.serve" not in traced["metrics"]  # listed for other cells only
    after = _digests(gp)
    assert all(after[p] == d for p, d in before.items())
