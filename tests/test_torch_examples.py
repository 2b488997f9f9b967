"""The port's two tuning examples (``examples_torch/``) run end to end on
the CPU at small settings and write their records."""

import importlib.util
import math
import pathlib

import pytest

from gaussian_process_tpu_torch.utils.logging import read_jsonl

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples_torch"


def _main(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def test_example_tune_hyperparms_regression(tmp_path):
    _main("tune_hyperparms_regression")(
        ["--device", "cpu", "--compare-acquisitions", "--bo-iters", "2",
         "--out", str(tmp_path)])
    records = {r["event"]: r for r in read_jsonl(str(tmp_path / "run.jsonl"))}
    assert math.isfinite(records["gradient_ascent_done"]["lml"])
    assert math.isfinite(records["bo_done"]["lml"])
    assert records["gradient_ascent_done"]["device"] == "cpu"


@pytest.mark.parametrize("flags", [["--skip-bo"], ["--bo-iters", "1", "--candidates", "4"]])
def test_example_co2(tmp_path, flags):
    _main("co2")(["--device", "cpu", "--years", "2", "--out", str(tmp_path), *flags])
    records = {r["event"]: r for r in read_jsonl(str(tmp_path / "run.jsonl"))}
    assert abs(records["book_lml"]["lml"] - 181.549) < 0.5
    band = records["band"]
    assert band["float64_max_mean_err_ppm"] < 1e-9
    assert math.isfinite(band["whitened_f32_max_mean_err_ppm"])
    if "--skip-bo" not in flags:
        assert records["bo_done"]["evaluations"] >= 1
        assert math.isfinite(records["batch_search"]["best_lml"])
