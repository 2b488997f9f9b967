"""Large-n GP regression sharded over a process mesh, on the PyTorch port
(the twin of ``examples/distributed_regression.py``).

X row-sharded over the ``data`` axis of the mesh, the posterior mean and
variance solved by ring-matvec block CG (K is never materialised; on the
card each ring step is the CUDA full-sweep matvec), the Nyström-
preconditioned segmented solve beside it, and sharded gradient-ascent
restarts over the ``restart`` axis.

One process is one rank. Alone, the script opens a one-rank group (on the
card with NCCL, or with ``--device cpu`` on the CPU with gloo). Under
``torchrun --nproc-per-node N`` the N ranks join one group (one card each,
or gloo ranks with ``--device cpu``):
    python examples_torch/distributed_regression.py --restarts 4
    torchrun --nproc-per-node 4 examples_torch/distributed_regression.py --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import torch
import torch.distributed as dist

from gaussian_process_tpu_torch import convert, ops, parallel
from gaussian_process_tpu_torch.utils import datasets
from gaussian_process_tpu_torch.utils.logging import JsonlLogger
from gaussian_process_tpu_torch.utils.profiling import time_fn


def resolve_device(name: str) -> torch.device:
    """``auto``: the card where CUDA is available, else the CPU."""
    if name == "auto":
        name = "cuda" if torch.cuda.is_available() else "cpu"
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    return torch.device(name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--restarts", type=int, default=0,
                    help="if >0, also run this many sharded gradient restarts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto")
    ap.add_argument("--out", default="artifacts/distributed_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    opened = not dist.is_initialized()
    if opened and "WORLD_SIZE" in os.environ:  # started by torchrun
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    mesh = parallel.make_mesh(device=device)  # opens a one-rank group if none exists
    world = dist.get_world_size()
    lead = dist.get_rank() == 0
    dev = parallel.mesh.mesh_device(mesh)
    if lead:
        print(f"ranks: {world}, mesh axes {mesh.mesh_dim_names} shape {tuple(mesh.shape)}, "
              f"device {dev}")

    n = (args.n // world) * world  # the block rows must divide the data axis
    x_np, y_np = datasets.large_scale_regression(n, args.d, seed=args.seed)
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    x_test = x[: args.n_test]

    kernel = ops.RBF()
    params = convert.params_from_numpy(kernel.init_params(), device=dev, dtype=torch.float32)

    # the posterior mean and variance by ring-matvec block CG
    solver = parallel.make_posterior_cg(kernel, mesh=mesh, noise_variance=1e-2)
    mean, var, alpha, iters, resnorm = solver(params, x, y, x_test)
    stats = time_fn(lambda: solver(params, x, y, x_test)[0], warmup=1, iters=3)
    std = float(torch.mean(torch.sqrt(var)))
    err = float(torch.mean(torch.abs(mean - y[: args.n_test])))

    os.makedirs(args.out, exist_ok=True)
    log = JsonlLogger(os.path.join(args.out, "run.jsonl")) if lead else None
    if lead:
        log.log("distributed_cg_done", n=n, d=args.d, ranks=world, device=str(dev),
                cg_iters=int(iters), residual=float(resnorm), solve_ms=stats["min_s"] * 1e3,
                mean_predictive_std=std)
        log.log("fit_check", mean_abs_err=err)
        print(f"n={n}: CG converged in {int(iters)} iters (residual {float(resnorm):.2e}), "
              f"solve {stats['min_s'] * 1e3:.1f} ms, mean predictive std {std:.4f}")
        print(f"mean |mu - y| at observed points: {err:.4f}")

    # the large-n path: Nyström-preconditioned segmented CG (bounded
    # segments, per-rank CG-state checkpoints, exact resume)
    mean_s, var_s, _alpha, it_s, res_s, _state = parallel.distributed_posterior_cg_segmented(
        kernel, params, x, y, x_test, mesh=mesh, noise_variance=1e-2,
        preconditioner="nystrom", precond_rank=min(256, n // 4), segment_iters=20)
    seg_err = float(torch.max(torch.abs(mean_s - mean)))
    if lead:
        log.log("segmented_nystrom_done", cg_iters=int(it_s), residual=float(res_s),
                max_abs_diff_vs_jacobi_solver=seg_err)
        print(f"segmented Nyström CG: {int(it_s)} iters (vs {int(iters)} Jacobi), "
              f"residual {float(res_s):.2e}, |d mean| {seg_err:.2e}")

    if args.restarts:
        gen = torch.Generator().manual_seed(args.seed)
        ls = 0.3 + 2.7 * torch.rand(args.restarts, generator=gen, dtype=torch.float32)
        params_batch = {"sigma": torch.ones(args.restarts), "lengthscale": ls}
        sub = min(512, n)
        # restarts spread over their own mesh: every rank on the restart axis,
        # when the rank count divides the candidates
        restart_mesh = (parallel.make_mesh(restart=world, data=1, device=device)
                        if args.restarts % world == 0 else mesh)
        res_params, lml, _, _ = parallel.sharded_gradient_restarts(
            kernel, params_batch, x[:sub], y[:sub], mesh=restart_mesh, noise_variance=1e-2,
            max_iters=100)
        best, best_lml = parallel.best_restart(res_params, lml)
        if lead:
            log.log("restarts_done", n_restarts=args.restarts, best_lml=best_lml,
                    best_lengthscale=float(best["lengthscale"]))
            print(f"best of {args.restarts} restarts: l={float(best['lengthscale']):.3f}, "
                  f"LML={best_lml:.2f}")
    if lead:
        log.close()
        print(f"artifacts in {args.out}/")
    if opened:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
