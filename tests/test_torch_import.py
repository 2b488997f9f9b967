"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package. Checked in a fresh interpreter, since this test process has
imported JAX already (tests/conftest.py)."""

import pathlib
import re
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parents[1] / "gaussian_process_tpu_torch"
EXAMPLES = PORT.parent / "examples_torch"
NEW_MODULES = ("gp.whitened", "opt.bo", "utils.checkpoint", "utils.datasets",
               "utils.logging", "utils.plotting", "utils.profiling",
               "parallel.classification", "parallel.multiclass", "parallel.multihost",
               "parallel.recovery")


def test_port_import_loads_no_jax():
    code = (
        "import sys, gaussian_process_tpu_torch, gaussian_process_tpu_torch.ops.cuda._build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gaussian_process_tpu' or m.startswith('gaussian_process_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parent, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_new_modules_load_no_jax_nor_matplotlib():
    code = (
        "import importlib, sys\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module('gaussian_process_tpu_torch.' + name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gaussian_process_tpu' or m.startswith('gaussian_process_tpu.')"
        " or m == 'sklearn' or m.startswith('sklearn.'))\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' not in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parent, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|gaussian_process_tpu\b(?!_torch))")
    offenders = [
        f"{path.relative_to(PORT.parent)}:{i}"
        for path in sorted([*PORT.rglob("*.py"), *EXAMPLES.glob("*.py"),
                            PORT.parent / "chip_smoke.py",
                            # the rank and process helpers of the port's tests
                            *(PORT.parent / "tests").glob("torch_*.py")])
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert offenders == []
