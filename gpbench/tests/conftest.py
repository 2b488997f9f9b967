"""Shared pieces of the benchmark's CPU tests: tiny cells of the two traffic
kinds, run through the harness on the CPU, where the port takes its plain
path (a dense K) and the reference its own."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpbench import harness, spec  # noqa: E402

TINY = {"name": "tiny", "n": 400, "d": 3, "dtype": "float32",
        "kernel": {"family": "rbf", "sigma": 1.0, "lengthscale": 2.0}, "noise": 0.01, "rank": 80,
        "data": {"inputs": "uniform", "half_width": 5.0, "target": "sin_sum", "frequency": 0.9,
                 "target_noise": 0.02, "seed": 400},
        "reference": {"tol": 1e-9, "rank": 200, "max_iters": 1000}}
# limits for the tiny cells, set from CPU readings by the rule of the card's
# cells (PERF.md §2): the smaller of the geometric mean of the program's
# largest reading and the control's smallest and ten times the program's,
# rounded up. Over 12 seeds the program read loss_gap up to 1.6e-6,
# change_gap 3.8e-5, mean_err 2.1e-3, var_err 2.0e-5; the TF32 control
# at least 0.18, 0.30, 0.044 and 9.6e-3
TINY_LIMITS = {"train": {"loss_gap": 2e-5, "change_gap": 4e-4, "capped_solves": 0},
               "serve": {"mean_err": 1e-2, "var_err": 2e-4, "capped_solves": 0}}
TRAFFIC = {"train": "train8", "serve": "serve64"}
E2E = {"train": "train_step_s", "serve": "query_s"}


def tiny_cell(kind: str, **traffic_changes) -> spec.Cell:
    bench = spec.read_json(spec.BENCHMARK)
    traffic = {**spec.read_json(spec.ROOT / "traffic" / f"{TRAFFIC[kind]}.json"),
               **traffic_changes}
    split = "train" if kind == "train" else "serve"
    e2e = [m for m in bench["end_to_end"] if m["name"] in ("setup_s", E2E[kind])]
    per_layer = [m for m in bench["per_layer"] if m["name"].endswith("." + split)]
    return spec.Cell(f"tiny.{TRAFFIC[kind]}", 1, TINY, traffic, TINY_LIMITS[kind], e2e,
                     per_layer)


def run_tiny(kind: str, seed: int = 3000000017, *, traced: bool = False, system: str = "port",
             seconds: float = 0.2, min_calls: int = 1, **traffic_changes) -> dict:
    torch.set_num_threads(2)
    return harness.run(tiny_cell(kind, **traffic_changes), seed, seconds, traced,
                       torch.device("cpu"), time.perf_counter(), system=system,
                       min_calls=min_calls)


@pytest.fixture(params=["train", "serve"])
def kind(request):
    return request.param
