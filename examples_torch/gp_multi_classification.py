"""Multi-class Laplace GP classification on three Gaussian blobs, on the
PyTorch port (the twin of ``examples/gp_multi_classification.py``).

[ref: GP_multi_classification.py:214-253 (__main__): blobs C=3, n=100, 60/40
split, shared RBF block per class, Laplace fit, accuracy print at :253].
Differences from the reference: block-structured R&W Alg 3.3 with per-class
n x n factorizations instead of one (Cn)x(Cn) Cholesky, the stride-60
hard-coding (quirk Q3) generalised, and the sign quirk Q4 fixed; the
reference's own trainer runs beside it for its metric.

``--solver cg`` is the matrix-free stacked-system Newton (one
preconditioned CG a step). The data is fp32 on ``--device`` (``auto``: the
card where CUDA is available, else the CPU). Plots are written when
matplotlib imports.

Run: python examples_torch/gp_multi_classification.py [--solver cg] [--out /tmp/gpmc_out]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from gaussian_process_tpu_torch import convert, gp, ops
from gaussian_process_tpu_torch.utils import datasets, plotting, profiling
from gaussian_process_tpu_torch.utils.logging import JsonlLogger


def resolve_device(name: str) -> torch.device:
    """``auto``: the card where CUDA is available, else the CPU."""
    if name == "auto":
        name = "cuda" if torch.cuda.is_available() else "cpu"
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    return torch.device(name)


def main(argv=None) -> None:
    # the CUDA library is built once per hash of its sources and kept here
    profiling.enable_persistent_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--centers", type=int, default=3)
    ap.add_argument("--n-samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--solver", choices=["cholesky", "cg"], default="cholesky",
                    help="cg = the matrix-free stacked-system Newton: one "
                         "preconditioned CG per step")
    ap.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto")
    ap.add_argument("--out", default="artifacts/gp_multiclass_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    X_train, X_test, y_train, y_test = datasets.blobs_multiclass(
        centers=args.centers, n_samples=args.n_samples, seed=args.seed)
    kernel = ops.RBF()
    params = convert.params_from_numpy(kernel.init_params(), device=device, dtype=torch.float32)
    Xtr = torch.tensor(X_train, dtype=torch.float32, device=device)
    Xte = torch.tensor(X_test, dtype=torch.float32, device=device)
    ytr = torch.tensor(y_train, device=device)

    if args.solver == "cg":
        state = gp.laplace_fit_multiclass_cg(kernel, params, Xtr, ytr, args.centers,
                                             precond_rank=min(48, Xtr.shape[0]))
        pred = gp.predict_multiclass_cg(kernel, params, state, Xtr, ytr, Xte, args.centers)
    else:
        state = gp.fit_multiclass(kernel, params, Xtr, ytr, args.centers)
        pred = gp.predict_multiclass(kernel, params, state, Xtr, ytr, Xte, args.centers)
    acc = float((pred.label.cpu().numpy() == y_test).mean())

    # the reference's metric: the damped trainer2 it actually runs, quirks
    # and all (Q4 sign, half-solve)
    state_ref = gp.fit_multiclass(kernel, params, Xtr, ytr, args.centers, mode="reference",
                                  max_iters=3000)
    pred_ref = gp.predict_multiclass(kernel, params, state_ref, Xtr, ytr, Xte, args.centers)
    acc_ref = float((pred_ref.label.cpu().numpy() == y_test).mean())

    errors = state.error_trace.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    with JsonlLogger(os.path.join(args.out, "run.jsonl")) as log:
        for i, e in enumerate(errors[np.isfinite(errors)]):
            log.newton_step(i + 1, float(e))
        log.log("multiclass_done", centers=args.centers, solver=args.solver, accuracy=acc,
                reference_mode_accuracy=acc_ref, newton_iters=int(state.iters),
                converged=bool(state.converged), device=str(device))

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("plots skipped: matplotlib is not installed")
    else:
        plotting.plot_convergence(errors, os.path.join(args.out, "newton.png"),
                                  title="Newton convergence (multi-class Laplace)")
        plotting.plot_classification_2d(
            X_train, y_train, X_test, pred.label.cpu().numpy(),
            os.path.join(args.out, "classification.png"),
            title=f"blobs C={args.centers}: accuracy {acc:.2%}")

    # the reference's print [ref: GP_multi_classification.py:253]: the
    # corrected algorithm's metric and the reference-faithful one
    print("mode               accuracy  iters")
    print(f"true Newton (3.3)  {acc:8.4f}  {int(state.iters):5d}")
    print(f"reference (Q4)     {acc_ref:8.4f}  {int(state_ref.iters):5d}")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
