#!/usr/bin/env python3
"""Drive the PyTorch port's GP regression serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX. Phases, each printing
one JSON line:

1. device: the card's name and power limit, toolchain versions, TF32 flags;
2. build: compiles ``gaussian_process_tpu_torch/csrc`` with ``nvcc``;
3. kernels: each hand-written CUDA kernel against its plain PyTorch version
   on the card (fp32, max abs error <= 2e-4 * max |plain|), and both timed
   with CUDA events at the main path's shapes (n = 102400);
4. exact: ``GPRegressor(...).fit(x, y).predict(..., solver="cholesky")`` at
   n = 8192, m = 2048, d = 4 in fp32, gated against the same inputs in
   float64 on the card (rel mean 5e-4, rel LML 3e-4, rel var 2e-3);
5. matrix-free: ``gp.posterior_cg`` at n = 102400 (Nyström rank 2048,
   tol 1e-3) with m = 8 (the symmetric sweep) and m = 64 (the full sweep),
   checked for convergence and for launches of each kernel, then the same
   pipeline at n = 4096 against the exact path (max abs error < 1e-2).

Then a line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gaussian_process_tpu_torch import convert, gp, ops
from gaussian_process_tpu_torch.models import GPRegressor
from gaussian_process_tpu_torch.ops.cuda import _build
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

BOOK = [66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19]
KERNEL_RTOL = 2e-4  # fp32 kernel vs plain: max abs err / max |plain|
GATE_MEAN, GATE_LML, GATE_VAR = 5e-4, 3e-4, 2e-3
N_EXACT, M_EXACT = 8192, 2048  # the exact path's training and test points
N_BIG, N_PARITY, D = 102400, 4096, 4  # the matrix-free path's sizes
# test points of the matrix-free runs, and the kernel each should reach:
# posterior_cg solves [y | K_s], so a kernel sees r = m + 1 columns
CG_RUNS = ((8, "gram_matvec_sym"), (64, "gram_matvec_full"))
MAIN_R = {name: m + 1 for m, name in CG_RUNS}
EXTRA_R = {"gram_matvec_sym": 16, "gram_matvec_full": 72}  # padded widths, checked too
KERNEL_SOURCE = "gaussian_process_tpu_torch/csrc/gram_matvec.cu"
REPLACES = {
    "gram_matvec_sym": "gaussian_process_tpu/ops/pallas/kernel_ops.py:391",
    "gram_matvec_full": "gaussian_process_tpu/ops/pallas/kernel_ops.py:303",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    require(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is off")
    emit(
        "device",
        nvidia_smi=smi,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc,
        triton=triton_version,
        python=sys.version.split()[0],
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    usage = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, nvcc_seconds=_build.build_info.get("seconds"),
         ptxas=usage)


def _case_kernels(device):
    f32 = lambda p: convert.params_from_numpy(p, device=device, dtype=torch.float32)
    co2 = ops.co2_kernel()
    return {
        "rbf": (ops.RBF(), f32({"sigma": 1.0, "lengthscale": 2.0})),
        "matern52": (ops.Matern(nu=2.5), f32({"sigma": 1.2, "lengthscale": 1.5})),
        "co2_no_white": (
            ops.Sum(children=co2.children[:4]),
            f32(ops.co2_params_from_vector(torch.tensor(BOOK, dtype=torch.float64))[:4]),
        ),
    }


def _max_err(got: torch.Tensor, want: torch.Tensor):
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    require(np.isfinite(err) and err <= KERNEL_RTOL * scale,
            f"kernel error {err:.3e} within {KERNEL_RTOL} x {scale:.3e}")
    return err, scale


def _run(name: str, kernel, params, x, v):
    sym = name == "gram_matvec_sym"
    return kops.gram_matvec(kernel, params, x, None, v, symmetric=sym)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(device, gen: np.random.Generator) -> dict:
    cases = _case_kernels(device)
    checked = []
    for n in (4096, 3001):
        x = torch.tensor(gen.uniform(-5, 5, (n, D)), dtype=torch.float32, device=device)
        for r in (1, 9, 16, 65, 72):
            v = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=device)
            for name in ("gram_matvec_sym", "gram_matvec_full"):
                if name == "gram_matvec_sym" and r > 64:
                    continue
                for family, (kernel, params) in cases.items():
                    before = kops.launch_counts[name]
                    got = _run(name, kernel, params, x, v)
                    torch.cuda.synchronize()
                    require(kops.launch_counts[name] == before + 1, f"{name} launched")
                    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
                    err, scale = _max_err(got, want)
                    checked.append([name, family, n, r, err, scale])
        # the full sweep with a second point set (x2 given)
        x2 = torch.tensor(gen.uniform(-5, 5, (n // 2 + 7, D)), dtype=torch.float32,
                          device=device)
        v2 = torch.tensor(gen.standard_normal((x2.shape[0], 9)), dtype=torch.float32,
                          device=device)
        kernel, params = cases["matern52"]
        got = kops.gram_matvec(kernel, params, x, x2, v2)
        err, scale = _max_err(got, kops.gram_matvec_reference(kernel, params, x, x2, v2))
        checked.append(["gram_matvec_full", "matern52_cross", n, 9, err, scale])
    emit("kernels_vs_plain", tolerance=f"max abs err <= {KERNEL_RTOL} x max|plain|",
         cases=checked)

    # at the main path's shapes: n = 102400, r = 9 (K3) and r = 65 (K2), as
    # the dispatch rule picks them; then the padded widths 16 and 72
    require(all(kops.use_symmetric(N_BIG, r) == (name == "gram_matvec_sym")
                for name, r in MAIN_R.items()), "main-path widths reach their kernels")
    kernel, params = cases["rbf"]
    x = torch.tensor(gen.uniform(-5, 5, (N_BIG, D)), dtype=torch.float32, device=device)
    timings, extra = {}, []
    for name, r in [*MAIN_R.items(), *EXTRA_R.items()]:
        v = torch.tensor(gen.standard_normal((N_BIG, r)), dtype=torch.float32, device=device)
        got = _run(name, kernel, params, x, v)
        want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
        err, scale = _max_err(got, want)
        # plain, kernel, kernel, plain: compare within one call, in turns
        plain_a = _time_ms(lambda: kops.gram_matvec_reference(kernel, params, x, None, v,
                                                              same=True), 3)
        ms_a = _time_ms(lambda: _run(name, kernel, params, x, v), 5)
        ms_b = _time_ms(lambda: _run(name, kernel, params, x, v), 5)
        plain_b = _time_ms(lambda: kops.gram_matvec_reference(kernel, params, x, None, v,
                                                              same=True), 3)
        row = {"kernel": name, "n": N_BIG, "r": r, "max_abs_err": err, "max_abs_plain": scale,
               "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
               "ms_runs": [ms_a, ms_b], "plain_ms_runs": [plain_a, plain_b]}
        if name in timings:
            extra.append(row)
        else:
            timings[name] = row
    emit("kernels_timed", kernel="RBF(sigma=1, lengthscale=2)", main_path=timings,
         padded_widths=extra)
    return timings


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b)) / (torch.max(torch.abs(b)) + 1e-12))


def phase_exact(device, gen: np.random.Generator) -> None:
    n, m = N_EXACT, M_EXACT
    x = gen.uniform(-5.0, 5.0, (n, D))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * gen.standard_normal(n)
    xs = gen.uniform(-5.0, 5.0, (m, D))
    x32, y32, xs32 = (torch.tensor(a, dtype=torch.float32) for a in (x, y, xs))

    def serve():
        model = GPRegressor(ops.RBF(), noise_variance=5e-4, device=device).fit(x32, y32)
        mean, std = model.predict(xs32, return_std=True, solver="cholesky")
        return model, mean, std

    serve()  # warm-up: cuSOLVER/cuBLAS handles and workspaces
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, mean, std = serve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    ref = GPRegressor(ops.RBF(), noise_variance=5e-4, device=device).fit(
        torch.from_numpy(x), torch.from_numpy(y))
    post64 = ref.posterior(torch.from_numpy(xs))
    require(mean.shape == (m,) and std.shape == (m,), "exact output shapes")
    require(bool(torch.isfinite(mean).all() and torch.isfinite(std).all()), "finite outputs")
    rel_mean = _rel(mean, post64.mean)
    rel_var = _rel(std.double() ** 2, post64.var)
    rel_lml = abs(float(model.log_marginal_likelihood()) - float(ref.log_marginal_likelihood())) \
        / abs(float(ref.log_marginal_likelihood()))
    emit("exact", n=n, m=m, d=D, dtype="float32", seconds=seconds,
         rel_mean=rel_mean, rel_lml=rel_lml, rel_var=rel_var,
         gates={"mean": GATE_MEAN, "lml": GATE_LML, "var": GATE_VAR})
    require(rel_mean <= GATE_MEAN and rel_lml <= GATE_LML and rel_var <= GATE_VAR,
            "exact path within the parity gates")


def _cg_problem(device, gen: np.random.Generator, n: int):
    x = torch.tensor(gen.uniform(-5.0, 5.0, (n, D)), dtype=torch.float32, device=device)
    noise = 0.02 * torch.tensor(gen.standard_normal(n), dtype=torch.float32, device=device)
    y = torch.sin(0.9 * x.sum(dim=1)) + noise
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 2.0}, device=device,
                                       dtype=torch.float32)
    return x, y, params


def phase_matrix_free(device, gen: np.random.Generator) -> dict:
    kernel = ops.RBF()
    x, y, params = _cg_problem(device, gen, N_BIG)
    tol, noise = 1e-3, 1e-2
    totals = {name: 0 for name in kops.launch_counts}
    for m, expect in CG_RUNS:
        xs = x[:m] + 0.1
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        post = gp.posterior_cg(kernel, params, x, y, xs, noise_variance=noise, tol=tol,
                               max_iters=120, preconditioner="nystrom", precond_rank=2048)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(kops.launch_counts)
        for name in totals:
            totals[name] += counts[name]
        require(counts[expect] > 0, f"{expect} launched in the m={m} run")
        # cg_solve stops at tol * max-column ||rhs||, rhs = [y | K_s]
        rhs = torch.cat([y[:, None], ops.gram(kernel, params, x, xs)], dim=1).double()
        stop = tol * float(torch.sqrt(torch.max(torch.sum(rhs * rhs, dim=0))))
        resnorm = float(post.resnorm)
        require(post.mean.shape == (m,) and bool(torch.isfinite(post.mean).all())
                and bool(torch.isfinite(post.var).all()), "finite CG outputs")
        emit("matrix_free", n=N_BIG, m=m, d=D, rank=2048, tol=tol, iters=post.iters,
             resnorm=resnorm, stop=stop, converged=resnorm <= stop, seconds=seconds,
             launches=counts)
        require(resnorm <= stop, f"CG converged at m={m}")

    # the same pipeline at n = 4096 against the exact path
    xs_small, ys_small = x[:N_PARITY], y[:N_PARITY]
    xs = x[:8] + 0.1
    dense = gp.posterior(kernel, params, xs_small, ys_small, xs, noise_variance=noise)
    small = gp.posterior_cg(kernel, params, xs_small, ys_small, xs, noise_variance=noise,
                            tol=1e-8, test_chunk=8, preconditioner="nystrom",
                            precond_rank=512)
    mean_err = float(torch.max(torch.abs(small.mean - dense.mean)))
    var_err = float(torch.max(torch.abs(small.var - dense.var)))
    emit("matrix_free_parity", n=N_PARITY, m=8, mean_abs_err=mean_err, var_abs_err=var_err,
         gate=1e-2)
    require(mean_err < 1e-2 and var_err < 1e-2, "CG vs Cholesky parity at n=4096")
    return totals


def main() -> int:
    phase_device()
    device = torch.device("cuda", 0)
    gen = np.random.default_rng(0)
    phase_build()
    timings = phase_kernels(device, gen)
    phase_exact(device, gen)
    launches = phase_matrix_free(device, gen)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"]}
        for name, t in timings.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
