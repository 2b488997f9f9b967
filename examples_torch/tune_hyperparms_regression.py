"""Hyperparameter tuning for GP regression: gradient ascent against
Bayesian optimisation, on the PyTorch port (the twin of
``examples/tune_hyperparms_regression.py``).

[ref: tune_hyperparms_regression.py:435-461 (__main__): N=3 train, n=100
test; BO over the lengthscale (3 iterations, PI) and gradient ascent on the
RBF lengthscale, ending with the cross-method LML agreement at :456-461]

The ascent differentiates the LML with autograd (no hand-derived dK/dl),
and all four acquisitions (PI/EI/UCB/TS) dispatch (quirk Q5 fixed). The
data is fp32 on ``--device`` (``auto``: the card where CUDA is available,
else the CPU), so on the card every LML's gram is the tile gram.

Run: python examples_torch/tune_hyperparms_regression.py [--acquisition PI]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from gaussian_process_tpu_torch import convert, gp, ops, opt
from gaussian_process_tpu_torch.utils import datasets, plotting
from gaussian_process_tpu_torch.utils.logging import JsonlLogger


def resolve_device(name: str) -> torch.device:
    """``auto``: the card where CUDA is available, else the CPU."""
    if name == "auto":
        name = "cuda" if torch.cuda.is_available() else "cpu"
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    return torch.device(name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=3)
    ap.add_argument("--n-test", type=int, default=100)
    ap.add_argument("--acquisition", choices=["PI", "EI", "UCB", "TS"], default="PI")
    ap.add_argument("--compare-acquisitions", action="store_true",
                    help="run all four acquisitions and plot the comparison")
    ap.add_argument("--bo-iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto")
    ap.add_argument("--out", default="artifacts/tune_hyperparms_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    _, x_train, y_train, _ = datasets.sine_regression(args.n_train, args.n_test,
                                                      seed=args.seed)
    kernel = ops.RBF()
    xtr = torch.tensor(x_train, dtype=torch.float32, device=device)
    ytr = torch.tensor(y_train, dtype=torch.float32, device=device)

    # gradient ascent on the lengthscale only
    # [ref: tune_hyperparms_regression.py:398-415 trains only l]
    params0 = convert.params_from_numpy(kernel.init_params(), device=device,
                                        dtype=torch.float32)
    ga = opt.tune_gradient_ascent(
        kernel, params0, xtr, ytr, noise_variance=5e-4, learning_rate=0.01, tol=1e-3,
        max_iters=10000, trainable={"sigma": False, "lengthscale": True},
    )
    lml_ga = float(ga.lml)
    l_ga = float(ga.params["lengthscale"])

    # Bayesian optimisation over the lengthscale
    # [ref: tune_hyperparms_regression.py:418-432: candidates in (0, 10)]
    def objective(theta: np.ndarray) -> float:
        p = convert.params_from_numpy({"sigma": 1.0, "lengthscale": float(theta[0])},
                                      device=device, dtype=torch.float32)
        return float(gp.log_marginal_likelihood(kernel, p, xtr, ytr, noise_variance=5e-4))

    acqs = ["PI", "EI", "UCB", "TS"] if args.compare_acquisitions else [args.acquisition]
    results = {
        acq: opt.tune_bayesian_opt(objective, initial_points=np.array([[1.0]]),
                                   bounds=(np.array([0.05]), np.array([10.0])),
                                   n_iterations=args.bo_iters, n_candidates=100,
                                   acquisition=acq, seed=args.seed)
        for acq in acqs
    }
    bo = max(results.values(), key=lambda r: r.best_value)
    lml_bo = bo.best_value
    l_bo = float(bo.best_params[0])

    # cross-method agreement [ref: tune_hyperparms_regression.py:456-461]
    rel_err = abs(lml_bo - lml_ga) / max(abs(lml_ga), 1e-12) * 100.0

    os.makedirs(args.out, exist_ok=True)
    with JsonlLogger(os.path.join(args.out, "run.jsonl")) as log:
        log.log("gradient_ascent_done", lengthscale=l_ga, lml=lml_ga, iters=ga.iters,
                device=str(device))
        log.log("bo_done", lengthscale=l_bo, lml=lml_bo, acquisition=args.acquisition,
                evaluations=len(bo.values))
        log.log("cross_method_agreement", rel_err_pct=rel_err)

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("plots skipped: matplotlib is not installed")
    else:
        if args.compare_acquisitions:
            curves = {a: np.maximum.accumulate(r.values) for a, r in results.items()}
            plotting.plot_acquisition_comparison(
                curves, os.path.join(args.out, "acquisition_comparison.png"),
                best_line=lml_ga, title="1-D BO: PI vs EI vs UCB vs TS",
            )
        plotting.plot_bo_progress(
            bo.values, os.path.join(args.out, "bo_progress.png"), best_line=lml_ga,
            title=f"BO ({args.acquisition}) vs gradient ascent",
        )
        trace = ga.lml_trace.numpy()
        plotting.plot_convergence(
            np.abs(np.diff(trace[np.isfinite(trace)])) + 1e-300,
            os.path.join(args.out, "ascent.png"), title="gradient-ascent |dLML|",
        )

    if args.compare_acquisitions:
        for a, r in results.items():
            print(f"BO({a:3s}): l = {float(r.best_params[0]):.4f}, "
                  f"LML = {r.best_value:.6f} ({len(r.values)} evals)")
    print(f"gradient ascent on {device}: l = {l_ga:.4f}, LML = {lml_ga:.6f} "
          f"({ga.iters} iters)")
    print(f"BO ({args.acquisition}): l = {l_bo:.4f}, LML = {lml_bo:.6f} "
          f"({len(bo.values)} evals)")
    print(f"error rate between BO and gradient ascent: {rel_err:.4f}%")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
