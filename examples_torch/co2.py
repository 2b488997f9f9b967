"""Mauna Loa CO2 on the PyTorch port: the composite kernel, BO over the
11-D hyperparameter space, a prescreen of every candidate, and the 20-year
extrapolation (the twin of ``examples/co2.py``).

[ref: CO2_example.py:404-423 (__main__): load Mauna Loa, mean-centre,
tune_hyperparameters_BO (:330-379: 10 iterations x 500 candidates per
acquisition, compared against the book hyperparameters at :324),
make_prediction on the 20-year monthly grid (:182-214,408) and plot
(:382-401)]

The workload is small (n = 526) but ill-conditioned (book amplitudes near
66 put K's diagonal near 4.4e3; kappa near 1e7). On ``--device`` (``auto``:
the card where CUDA is available, else the CPU):
  - the BO search's objective is the whitened float64 LML
    (``gp.make_whitened_lml_fn``);
  - a prescreen scores every candidate of the search's budget by the
    whitened fp32 LML (one tile gram each on the card), and the top 16 are
    re-ranked in float64;
  - the 20-year band runs whitened in fp32 and plainly in float64, each
    held against the float64 posterior on the host, errors in run.jsonl.
All four acquisitions dispatch (quirk Q5 fixed), and the LML is the
corrected formula (quirk Q1). Plots are written when matplotlib imports.

Run:
  python examples_torch/co2.py                        # BO with one acquisition
  python examples_torch/co2.py --compare-acquisitions # the reference's 4-way run
  (defaults are scaled down; --bo-iters 10 --candidates 500 is the
  reference's full search)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch

from gaussian_process_tpu_torch import gp, ops
from gaussian_process_tpu_torch.opt import tune_bayesian_opt
from gaussian_process_tpu_torch.utils import datasets, plotting
from gaussian_process_tpu_torch.utils.logging import JsonlLogger

# GPML sec. 5.4.3 book hyperparameters [ref: CO2_example.py:324]
THETA_BOOK = np.array([66.0, 67.0, 2.4, 90.0, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])
NOISE = 5e-4  # [ref: CO2_example.py:139]
ACQUISITIONS = ["PI", "EI", "UCB", "TS"]  # all four, really [ref: CO2_example.py:341]
RERANK = 16  # prescreened candidates re-ranked in float64


def resolve_device(name: str) -> torch.device:
    """``auto``: the card where CUDA is available, else the CPU."""
    if name == "auto":
        name = "cuda" if torch.cuda.is_available() else "cpu"
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    return torch.device(name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bo-iters", type=int, default=5)
    ap.add_argument("--candidates", type=int, default=100)
    ap.add_argument("--acquisition", choices=ACQUISITIONS, default="PI")
    ap.add_argument("--compare-acquisitions", action="store_true",
                    help="run all four acquisitions and plot the comparison "
                         "[ref: CO2_example.py:330-379]")
    ap.add_argument("--years", type=int, default=20)
    ap.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto",
                    help="where the search and the band run: auto = the card "
                         "where CUDA is available, else the CPU")
    ap.add_argument("--skip-bo", action="store_true", help="just fit at the book values")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/co2_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    x_np, y_np, y_mean = datasets.mauna_loa()
    kernel = ops.co2_kernel()
    f64 = lambda a, dev: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    x, y = f64(x_np, device), f64(y_np, device)

    def lml_at(theta: np.ndarray) -> float:
        params = ops.co2_params_from_vector(f64(theta, device))
        return float(gp.log_marginal_likelihood(kernel, params, x, y, noise_variance=NOISE))

    lml_book = lml_at(THETA_BOOK)
    os.makedirs(args.out, exist_ok=True)
    log = JsonlLogger(os.path.join(args.out, "run.jsonl"))
    log.log("book_lml", theta=THETA_BOOK, lml=lml_book, device=str(device))
    print(f"LML at book hyperparams: {lml_book:.4f}")

    # book-anchored candidate box [ref: CO2_example.py:109-128]
    lo = np.maximum(THETA_BOOK * 0.5, 1e-3)
    hi = THETA_BOOK * 1.5
    lml64_batch = gp.make_whitened_lml_fn(kernel, ops.co2_params_from_vector, x_np, y_np,
                                          noise_variance=NOISE, dtype=torch.float64,
                                          device=device)
    lml32_batch = gp.make_whitened_lml_fn(kernel, ops.co2_params_from_vector, x_np, y_np,
                                          noise_variance=NOISE, dtype=torch.float32,
                                          device=device)

    theta_best = THETA_BOOK
    best_lml = lml_book
    plots = True
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        plots = False
        print("plots skipped: matplotlib is not installed")
    if not args.skip_bo:
        where = f"{device.type}_whitened_float64"
        runs = ACQUISITIONS if args.compare_acquisitions else [args.acquisition]
        results = {}
        for acq in runs:
            t0 = time.perf_counter()
            bo = tune_bayesian_opt(
                lambda theta: float(lml64_batch(theta)[0]),
                initial_points=THETA_BOOK[None, :] + 0.5, bounds=(lo, hi),
                n_iterations=args.bo_iters, n_candidates=args.candidates, acquisition=acq,
                seed=args.seed,
            )
            bo_wall = time.perf_counter() - t0
            results[acq] = bo
            verdict = "beats" if bo.best_value > lml_book else "loses to"
            print(f"BO({acq:3s}) on {where}: best LML {bo.best_value:10.4f} "
                  f"after {len(bo.values)} evaluations in {bo_wall:.1f}s; "
                  f"{verdict} book {lml_book:.4f}")
            log.log("bo_done", acquisition=acq, best_lml=bo.best_value,
                    evaluations=len(bo.values), stopped_early=bo.stopped_early,
                    objective_device=where, wall_s=bo_wall)
            if bo.best_value > best_lml:
                best_lml, theta_best = bo.best_value, bo.best_params

        # every candidate of the search's budget scored by the fp32
        # whitened LML, the top RERANK re-ranked in float64 [ref:
        # CO2_example.py:330-379 evaluates only the surrogate's pick]
        rng = np.random.default_rng(args.seed + 1)
        n_total = args.bo_iters * args.candidates
        cand = rng.uniform(lo, hi, size=(n_total, THETA_BOOK.size))
        t0 = time.perf_counter()
        scores32 = lml32_batch(cand)
        top = np.argsort(scores32)[-RERANK:]
        scores64 = lml64_batch(cand[top])
        batch_wall = time.perf_counter() - t0
        bi = int(np.argmax(scores64))
        print(f"batch search: {n_total} candidates prescreened in fp32, top {RERANK} "
              f"re-ranked in float64 in {batch_wall:.1f}s; best LML {scores64[bi]:.4f}")
        log.log("batch_search", n_candidates=n_total, wall_s=batch_wall,
                best_lml=float(scores64[bi]), prescreen_dtype="float32", rerank_k=RERANK,
                rerank_max_abs_dlml=float(np.max(np.abs(scores32[top] - scores64))))
        if scores64[bi] > best_lml:
            best_lml, theta_best = float(scores64[bi]), cand[top][bi]

        if plots and args.compare_acquisitions:
            curves = {a: np.maximum.accumulate(r.values) for a, r in results.items()}
            plotting.plot_acquisition_comparison(
                curves, os.path.join(args.out, "acquisition_comparison.png"),
                best_line=lml_book, title="CO2 BO: PI vs EI vs UCB vs TS (book LML dashed)",
            )
        elif plots:
            plotting.plot_bo_progress(
                results[runs[0]].values, os.path.join(args.out, "bo_progress.png"),
                best_line=lml_book, title=f"CO2 BO ({runs[0]}) vs book hyperparams",
            )

    # the 20-year monthly extrapolation at the winning hyperparameters
    # [ref: CO2_example.py:404-423], float64 on the host as the reference
    xt_np = datasets.mauna_loa_test_grid(x_np, years=args.years)
    host = torch.device("cpu")
    post = gp.posterior(kernel, ops.co2_params_from_vector(f64(theta_best, host)),
                        f64(x_np, host), f64(y_np, host), f64(xt_np, host),
                        noise_variance=NOISE)
    log.log("extrapolation_done", lml=float(post.lml),
            first_mean_ppm=float(post.mean[0] + y_mean),
            last_mean_ppm=float(post.mean[-1] + y_mean))

    # the same band on the device: whitened fp32, and plain float64
    w = gp.whitened_posterior(kernel, ops.co2_params_from_vector(f64(theta_best, host)),
                              x_np, y_np, xt_np, noise_variance=NOISE,
                              dtype=torch.float32, device=device)
    post_dev = gp.posterior(kernel, ops.co2_params_from_vector(f64(theta_best, device)),
                            x, y, f64(xt_np, device), noise_variance=NOISE)
    err = lambda a, b: float(torch.max(torch.abs(a.double().cpu() - b)))  # noqa: E731
    band = {
        "whitened_f32_max_mean_err_ppm": err(w.mean, post.mean),
        "whitened_f32_max_std_err_ppm": err(w.std, post.std),
        "whitened_f32_jitter": float(w.jitter),
        "whitened_f32_lml_abs_err": abs(w.lml - float(post.lml)),
        "float64_max_mean_err_ppm": err(post_dev.mean, post.mean),
        "float64_max_std_err_ppm": err(post_dev.std, post.std),
        "float64_lml_abs_err": abs(float(post_dev.lml) - float(post.lml)),
    }
    log.log("band", device=str(device), years=args.years, **band)
    log.close()
    print(f"band on {device}: whitened fp32 max |d mean| "
          f"{band['whitened_f32_max_mean_err_ppm']:.3f} ppm, |d std| "
          f"{band['whitened_f32_max_std_err_ppm']:.3f}; float64 |d mean| "
          f"{band['float64_max_mean_err_ppm']:.2e} ppm, |d LML| "
          f"{band['float64_lml_abs_err']:.2e}")

    if plots:
        for path, mean, std, where in (("extrapolation.png", post.mean, post.std, "host"),
                                       ("extrapolation_device.png", w.mean, w.std,
                                        f"{device}, whitened fp32")):
            plotting.plot_gp_band(
                xt_np, mean.double().cpu() + y_mean, std, os.path.join(args.out, path),
                x_train=x_np[-120:], y_train=y_np[-120:] + y_mean,
                title=f"Mauna Loa CO2 ({where}): {args.years}-year extrapolation",
            )
    print(f"extrapolated CO2 at {float(xt_np[-1, 0]):.2f}: "
          f"{float(post.mean[-1] + y_mean):.1f} ppm")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
