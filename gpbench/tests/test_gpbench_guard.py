"""No run loads JAX or the JAX package, and the reference imports nothing of
the program under test. The port's name begins with the JAX package's, so
names are compared whole, by their top-level part."""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from conftest import ROOT
from gpbench import harness

GPBENCH = ROOT / "gpbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((GPBENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        tops = {_top(n) for n in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}, (path, tops)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT) for p in GPBENCH.rglob("*.py")),
                         ids=str)
def test_no_benchmark_file_imports_jax(path):
    tops = {_top(n) for n in _imports(ROOT / path)}
    assert not tops & set(harness.FORBIDDEN), tops


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussian_process_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "gaussian_process_tpu.ops", object())
    found = harness.forbidden_modules()
    assert "jax" in found and "gaussian_process_tpu" in found
    assert "gaussian_process_tpu_torch" not in found


def test_a_run_loads_neither_jax_nor_the_jax_package():
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / 'gpbench' / 'tests')!r})
        from conftest import run_tiny
        res = run_tiny("serve")
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"correct": res["correct"], "tops": tops}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["tops"]) & set(harness.FORBIDDEN)
    assert "gaussian_process_tpu_torch" in got["tops"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    from conftest import run_tiny

    monkeypatch.setitem(sys.modules, "jax", object())
    assert run_tiny("serve") is None
