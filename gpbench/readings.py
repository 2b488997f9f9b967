"""The readings that the check's limits are set from: a cell's numbers over
many seeds, for the program (``--system port``) or for the control in its
place (``--system control``: the plain reference at the cell's own
settings, computed in TF32), in one process so that set-up is paid once
for the CUDA context and the library:

    python3 -m gpbench.readings --workload reg100k.train8 --system control \
        --seeds 11 12 13

Each seed is one run of the cell (``harness.run``): a training cell runs
no window, so its check follows set-up's call alone; a serve cell's window
runs the queries a run checks, and the control leaves out the warm-up
query. One JSON line a seed goes to standard output. The benchmark's own
runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from gpbench import harness, spec

    ap = argparse.ArgumentParser(prog="python3 -m gpbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=("port", "control"), default="port")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("readings are taken on the card only")
        return 2
    cell = spec.load_cell(args.workload)
    t0 = T0
    for seed in args.seeds:
        calls = cell.traffic.get("check_queries", 0)
        res = harness.run(cell, seed, 0.0, False, torch.device("cuda"), t0, system=args.system,
                          warm=args.system == "port", min_calls=calls)
        if res is None:
            return 3
        print(json.dumps({"workload": cell.name, "system": args.system, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
