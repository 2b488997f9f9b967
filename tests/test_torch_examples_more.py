"""The port's regression, classification and distributed examples
(``examples_torch/``) run end to end on the CPU at small settings and
write their records."""

import importlib.util
import math
import pathlib

import pytest
import torch

from gaussian_process_tpu_torch.utils.logging import read_jsonl

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples_torch"


def _main(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def _records(path):
    return {r["event"]: r for r in read_jsonl(str(path / "run.jsonl"))}


@pytest.mark.parametrize("kernel", ["rbf", "periodic", "linear"])
def test_torch_example_gp_regression(tmp_path, kernel):
    _main("gp_regression")(["--device", "cpu", "--kernel", kernel, "--num-functions", "3",
                            "--out", str(tmp_path)])
    done = _records(tmp_path)["regression_done"]
    assert math.isfinite(done["lml"]) and done["samples_finite"]
    assert done["device"] == "cpu"
    if kernel == "rbf":  # the reference's headline setting fits the sine
        assert done["mean_abs_err"] < 0.5


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_torch_example_gp_binary_classification(tmp_path, solver):
    _main("gp_binary_classification")(["--device", "cpu", "--solver", solver,
                                       "--out", str(tmp_path)])
    records = _records(tmp_path)
    done = records["classification_done"]
    assert done["accuracy"] >= 0.9 and done["converged"]
    assert done["newton_iters"] <= 10 < done["reference_mode_iters"]
    assert records["newton_step"]["iteration"] == done["newton_iters"]
    assert math.isfinite(done["laplace_lml"])


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_torch_example_gp_multi_classification(tmp_path, solver):
    _main("gp_multi_classification")(["--device", "cpu", "--solver", solver,
                                      "--out", str(tmp_path)])
    done = _records(tmp_path)["multiclass_done"]
    assert done["accuracy"] >= 0.9 and done["converged"]
    assert done["reference_mode_accuracy"] >= 0.9


def test_torch_example_distributed_regression(tmp_path):
    """One gloo rank, opened by the example and closed at its end."""
    _main("distributed_regression")(["--device", "cpu", "--n", "256", "--d", "2",
                                     "--n-test", "16", "--restarts", "2",
                                     "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    records = _records(tmp_path)
    cg = records["distributed_cg_done"]
    assert cg["ranks"] == 1 and 0 < cg["cg_iters"] < 1000
    assert records["fit_check"]["mean_abs_err"] < 0.2
    seg = records["segmented_nystrom_done"]
    assert seg["cg_iters"] < cg["cg_iters"] and seg["max_abs_diff_vs_jacobi_solver"] < 1e-3
    assert math.isfinite(records["restarts_done"]["best_lml"])
