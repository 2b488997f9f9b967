"""Exact GP regression on the sine dataset, the reference's headline demo,
on the PyTorch port (the twin of ``examples/gp_regression.py``).

[ref: GP_regression.py:300-315 (__main__): N=5 train, n=100 test, RBF
sigma=1, l=1, noise 5e-4; prior sampling, posterior mean/band, plots]

The data is fp32 on ``--device`` (``auto``: the card where CUDA is
available, else the CPU); the factorization runs in float64, as the port's
exact path does. Plots are written when matplotlib imports.

Run: python examples_torch/gp_regression.py [--out /tmp/gp_out] [--kernel rbf|periodic|linear]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from gaussian_process_tpu_torch import convert, gp, ops
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
    ap.add_argument("--n-train", type=int, default=5)
    ap.add_argument("--n-test", type=int, default=100)
    ap.add_argument("--kernel", choices=["rbf", "periodic", "linear"], default="rbf")
    ap.add_argument("--noise", type=float, default=5e-4)
    ap.add_argument("--num-functions", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto")
    ap.add_argument("--out", default="artifacts/gp_regression_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    true_fn, x_train, y_train, x_test = datasets.sine_regression(
        args.n_train, args.n_test, seed=args.seed)
    kernel = {"rbf": ops.RBF, "periodic": ops.Periodic, "linear": ops.Linear}[args.kernel]()
    params = convert.params_from_numpy(kernel.init_params(), device=device, dtype=torch.float32)

    xtr = torch.tensor(x_train, dtype=torch.float32, device=device)
    ytr = torch.tensor(y_train, dtype=torch.float32, device=device)
    xte = torch.tensor(x_test, dtype=torch.float32, device=device)

    g_prior = torch.Generator(device=device).manual_seed(args.seed)
    g_post = torch.Generator(device=device).manual_seed(args.seed + 1)
    prior_paths = gp.sample_prior(kernel, params, xte, g_prior,
                                  num_functions=args.num_functions, jitter=args.noise)
    post = gp.posterior(kernel, params, xtr, ytr, xte, noise_variance=args.noise)
    post_paths = gp.sample_posterior(kernel, params, post, xte, g_post,
                                     num_functions=args.num_functions)
    mean = post.mean.cpu().numpy()
    mean_abs_err = float(np.mean(np.abs(mean - true_fn(x_test).ravel())))

    os.makedirs(args.out, exist_ok=True)
    with JsonlLogger(os.path.join(args.out, "run.jsonl")) as log:
        log.log("regression_done", kernel=args.kernel, n_train=args.n_train,
                n_test=args.n_test, lml=float(post.lml), mean_abs_err=mean_abs_err,
                jitter=float(post.jitter), device=str(device),
                samples_finite=bool(torch.isfinite(post_paths).all()
                                    and torch.isfinite(prior_paths).all()))

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("plots skipped: matplotlib is not installed")
    else:
        plotting.plot_gp_band(
            x_test, mean, post.std.cpu().numpy(), os.path.join(args.out, "posterior.png"),
            x_train=x_train, y_train=y_train, samples=post_paths.cpu().numpy().T,
            true_fn=true_fn, title=f"GP posterior ({args.kernel})")
        plotting.plot_gp_band(
            x_test, np.zeros(args.n_test),
            np.sqrt(ops.gram_diag(kernel, params, xte).cpu().numpy()),
            os.path.join(args.out, "prior.png"), samples=prior_paths.cpu().numpy().T,
            title=f"GP prior ({args.kernel})")
        plotting.plot_kernel_matrix(
            ops.gram(kernel, params, xte).cpu().numpy(), os.path.join(args.out, "kernel.png"),
            title=f"{args.kernel} kernel on test grid")

    print(f"LML = {float(post.lml):.4f}")
    print(f"mean |mu* - f| = {mean_abs_err:.4f}")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
