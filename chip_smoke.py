#!/usr/bin/env python3
"""Drive the PyTorch port's GP regression serving and training paths, its
Laplace classification paths, its blocked Cholesky, its segmented solvers,
its CO2 pipeline, its data-parallel tier and distributed classifiers (at
one rank) and its multi-host bring-up (one process) once on one NVIDIA
GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX. Phases, each printing
one JSON line:

1. device: the card's name and power limit, toolchain versions, TF32 flags;
2. build: compiles ``gaussian_process_tpu_torch/csrc`` with ``nvcc``;
3. kernels: each hand-written CUDA kernel against its plain PyTorch version
   on the card (fp32, max abs error <= 2e-4 * max |plain|; K2 under both
   ``dot_mode``s, up to r = 512), and both timed with CUDA events at the
   main path's shapes (n = 102400; K2 at r = 65, 72 and 512, run twice
   with equal bits, within 2e-5 x max |float64| of float64 (3xTF32 is
   near fp32; a 1xTF32 product, the plain version with TF32 matmuls,
   recorded beside it, is not); K3 at r = 9, 1, 3 and 16, and run twice
   at r = 9, where its fixed-point sum must give equal bits, with its
   device time by kernel; K3 at the classifiers' d = 2, RBF(1, 1), r = 1
   and 3; K3 against K2 at r in {9, 16, 33, 64} and n in {4096, 102400},
   recorded for the sweep rule); the tile gram
   (K1) also within 1e-4 x max(1, max |plain|) absolute, timed at
   n = 8192 and 102400 x {512, 2048} beside a ``fill_`` of the same bytes
   (the achievable store rate); its autograd wrapper (K5): gradients within
   1e-3 of the plain gram's in float64, one launch of its backward kernel
   per backward, and a same-set Matern x-gradient finite and within 2e-4 x
   max |plain| of the float64 plain VJP; K5's backward alone at n = 8192,
   d = 4 (params only, and with dx) within 1e-3 per coefficient of the
   float64 plain VJP, equal bits on a rerun, timed beside its plain version
   and a ``torch.sum`` of the cotangent (the achievable read rate);
4. exact: ``GPRegressor(...).fit(x, y).predict(..., solver="cholesky")`` at
   n = 8192, m = 2048, d = 4 in fp32, gated against the same inputs in
   float64 on the card (rel mean 5e-4, rel LML 3e-4, rel var 2e-3); it must
   launch K1 and K5;
5. matrix-free: ``gp.posterior_cg`` at n = 102400 (Nyström rank 2048,
   tol 1e-3) with m = 8 (the symmetric sweep) and m = 64 (the full sweep),
   checked for convergence and for launches of each kernel; the m = 8 run
   twice, with equal CG iterations and bitwise-equal means and variances;
   then the same pipeline at n = 4096 against the exact path (max abs
   error < 1e-2);
6. kernels_bwd: K4's two CUDA backward sweeps against their plain version
   in float64 (dL/dcoef within 1e-3 relative per coefficient, dL/dx within
   2e-4 x max |plain|) for RBF, Matern 5/2 and co2 without White at
   n in {4096, 3001}, r in {1, 8, 9}: the full sweep same-set and
   cross-set, with and without dx, the symmetric sweep same-set without
   dx; the params gradient through the CUDA ``gram_matvec`` (the symmetric
   sweep) against autograd through the plain version; then at n = 102400
   the symmetric sweep at the width a training step hands it (r = 9) and at
   r = 1, timed beside the full sweep and the plain VJP on the same inputs,
   and the full sweep at its own path's shape (n = 4096, r = 65);
7. train_exact: ``GPRegressor(...).fit(x, y, optimize=True, max_iters=50)``
   (Adam, log transform) at n = 8192 in fp32, gated against the same run in
   float64 (rel LML 3e-4, rel params 1e-3); it must launch K1 and K5, one
   K5 backward per differentiated forward (the device time of 5 steps by
   kernel, ``torch.profiler``, is taken after phase 12);
8. train_large: ``opt.tune_large_scale`` at n = 102400 (8 probes, Nyström
   rank 2048, cg_tol 1e-4, 3 steps), which must launch K3 and exactly one
   symmetric K4 sweep per step (one matvec on [alpha | z], r = 9) and no
   full one; then, read as a path of its own, at n = 4096 the surrogate's
   gradient (64 probes: 65 columns, past the symmetric rule, so one full
   K4 sweep) within 0.1 of the exact float64 LML gradient, and 10 steps
   (a symmetric sweep each) raising the exact LML by more than 1.0;
9. classify_dense: ``GPBinaryClassifier`` and ``GPMulticlassClassifier``
   (C = 3) ``fit(..., solver="cholesky")`` and ``predict_proba`` at
   n = 4096, m = 2048, d = 2, RBF(1, 1), fp32 gated against float64 on the
   card (max |d prob| <= 5e-3, label agreement >= 0.999);
10. classify_large: ``gp.laplace_fit_cg`` + ``gp.predict_binary_cg`` at
    n = 102400 (rank 512, cg_tol 1e-4, m = 2048, chunks of 512) and
    ``gp.laplace_fit_multiclass_cg`` + ``gp.predict_multiclass_cg`` (C = 3,
    rank 256, chunks of 2048): both fits must converge, with K3 (Newton),
    K2 (the binary variance solves) and K1 (cross-grams) launched; then the
    same pipelines at n = 4096 against the dense path under the gates of 9;
    then estimator_numpy: ``GPBinaryClassifier(RBF).fit(x, y,
    solver="auto")`` from NumPy float64 at n = 40000, which must store fp32,
    go matrix-free through K3 and converge, and whose probabilities must
    agree with the same fit from fp32 tensors (max |d prob| 5e-3);
11. kernels_chol: the panel factor and inverse (K6) against its plain
    version in fp32, each against float64 ``torch.linalg`` (L and W within
    1e-5 x max |float64| where the plain version is, else within 2x the
    plain version's own error; exact zeros above the diagonal), on the chol
    mode's first diagonal panel (b = 1024) and on X X^T / b + I at b = 1024,
    96 (ragged) and 640; NaN down L's diagonal from an indefinite pivot;
    then K6, the plain version and ``cholesky_ex`` + ``solve_triangular(L,
    I)`` timed at b = 1024, with K6's device time by kernel and the share
    of its diagonal-tile kernel;
12. chol_blocked: the JAX bench's chol mode at full width, n = 10240,
    d = 4, RBF(1, 1) + 5e-4 I in fp32 (K by K1): ``linalg.blocked_cholesky
    (block=1024, use_kernel=True)`` with exactly 10 K6 launches, alpha by
    ``blocked_tri_solve`` with shared ``panel_inverses``, and the LML; beside
    it the library-panel blocked factor, fp32 ``cholesky_ex`` and float64
    ``torch.linalg`` on the same K, each timed, with its backward error
    max |L L^T - K| / max |K| (in float64) and its rel LML (reported, not
    gated). Gate: the K6-panel factor is finite with a backward error within
    2x the library-panel factor's + 1e-7;
13. segmented: ``gp.posterior_cg_segmented`` on phase 5's problem (n =
    102400, d = 4, RBF(1, 2), noise 1e-2, tol 1e-3, Nyström rank 2048) with
    m = 64 in chunks of 8 and at most 2 CG iterations a segment: every
    chunk's final residual within tol x its largest right-hand-side column
    norm, K3 and K1 launched; a run stopped after the second segment of
    chunk 3, its snapshot saved by ``utils.checkpoint`` and restored into a
    zeroed template, resumed in a new call with the uninterrupted run's
    total iterations and bitwise-equal means and variances (K3's
    fixed-point sum); at n = 4096 the same pipeline within 1e-2 of the
    exact path;
14. segmented_laplace: ``gp.laplace_fit_cg_segmented`` on phase 10's
    binary problem (n = 102400, d = 2, RBF(1, 1), rank 512, cg_tol 1e-4),
    one Newton step a call: it converges through K3; a run stopped after 3
    steps, its iterate saved and restored, continued by ``resume_f`` to the
    uninterrupted mode with equal bits and Newton count; its
    ``predict_binary_cg`` within 5e-3 of ``laplace_fit_cg``'s;
15. co2: the vendored Mauna Loa record (526 points) at the book
    hyperparameters: (a) ``gp.whitened_posterior`` in fp32 over the 20-year
    monthly grid against float64 ``gp.posterior`` on the card (mean within
    1.0 ppm, std within 0.1 ppm, K1 launched for K and K_s; K1 timed at
    this shape); (b) ``gp.make_whitened_lml_fn`` over 500 candidates in the
    0.5x-1.5x book box in fp32 (exactly 500 K1 launches) and float64 (within
    rtol 1e-10 of the serial ``whitened_lml``, and 1e-8 of the direct LML
    at the book values), the fp32 drift reported; (c)
    ``opt.tune_bayesian_opt`` on the float64 whitened LML, PI, EI, UCB and
    TS, 10 iterations x 500 candidates, seed 0: EI, UCB and TS within 5% of
    the book LML, the best of all above it, and PI stopped after its first
    proposal (its unit-RBF surrogate makes that proposal the first
    candidate, so its best is one uniform draw); (d)
    ``examples_torch/co2.py --skip-bo`` and
    ``examples_torch/tune_hyperparms_regression.py`` as subprocesses, each
    exiting 0 with a finite LML in its ``run.jsonl``;
16. distributed: the data-parallel tier (``parallel``) at one rank, a
    one-rank NCCL group on an in-process store that the phase destroys:
    (a) ``make_posterior_cg`` (Nyström rank 2048, tol 1e-3) on phase 5's
    problem at m = 64, converged, within 1e-2 of ``gp.posterior_cg`` in
    mean and variance, with K2 (every ring step) and K1 launched and K3
    not; (b) ``distributed_posterior_cg_segmented`` on it, 6 iterations a
    segment, each rank's state saved by ``utils.checkpoint`` after segments
    1 and 2 and resumed from each with equal iterations and bits, and the
    jacobi segments at n = 4096 equal to the monolithic jacobi solve; (c)
    ``make_distributed_posterior`` at n = 8192, m = 2048 in fp32 against
    float64 on the card under phase 4's gates, K1 launched; (d)
    ``make_distributed_train_step``, 5 steps at n = 8192, one candidate:
    the fp32 LML trajectory within rel 3e-4 of float64's, one K5 backward a
    step; (e) ``examples_torch/gp_regression.py``,
    ``gp_binary_classification.py``, ``gp_multi_classification.py`` and
    ``distributed_regression.py --restarts 4`` as subprocesses at their
    defaults, each exiting 0 with its record;
17. distributed_classify: the distributed classifiers at one rank, a
    one-rank NCCL group that the phase destroys: (a)
    ``parallel.distributed_fit_predict_binary`` on phase 10's binary
    problem (n = 102400, rank 512, cg_tol 1e-4, m = 2048, all m columns in
    one block-CG solve) against ``gp.laplace_fit_cg`` +
    ``gp.predict_binary_cg`` on the same inputs: converged, max |d prob|
    <= 5e-3 and labels >= 0.999, K2 (every ring step, the Newton steps'
    one-column matvecs too) and K1 (the cross-grams) launched and K3 not;
    K2 as a ring step calls it, at r = 1 and r = 2048, checked against and
    timed beside its plain version; (b) ``parallel.fit_multiclass_sharded``
    on phase 9's problem (n = 4096, C = 3) in fp32 against
    ``gp.fit_multiclass`` in fp32 and in float64 on the card, its
    ``gp.predict_multiclass`` under phase 9's gates against the float64
    fit's, K1 launched once;
18. multihost: ``parallel.multihost`` in one process on NCCL over a TCP
    store on localhost: the coordinator and the global mesh;
    ``host_local_to_global`` into ``make_distributed_posterior`` at
    n = 8192, m = 2048 in fp32 under phase 4's gates against float64, K1
    launched; ``sync_hosts`` with and without a timeout, ``live_hosts() ==
    [0]``; a per-rank checkpoint of a card tensor restored with equal bits;
    ``run_with_redispatch`` around ``make_sharded_lml`` over 8 float64
    candidates at n = 8192, d = 4, one lost on the first attempt: 2
    attempts, every value within rel 1e-8 of ``gp.log_marginal_likelihood``
    on the card; ``shutdown``.

Then a line ``{"kernels": [...]}``: per kernel its source, the TPU kernel it
replaces, its launches on the main paths, its error against its plain
version, its time, the plain version's, its bound (the larger of its fp32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s, from this run's shapes;
for K2 its TF32 products at 495 TFLOP/s against its entries at 67) and,
where one PyTorch call computes the same function, that call's time.
Last, ``{"ok": true, "device": ...}``. Any failure raises and exits
non-zero; so does a machine without CUDA. Each phase draws its inputs from
its own generator, ``np.random.default_rng([0, k])`` with k fixed for the
phase (phases 13-18 take k = 13 to 18), so a phase that draws more
leaves the others' inputs as they were.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gaussian_process_tpu_torch import convert, gp, linalg, ops, opt
from gaussian_process_tpu_torch.models import (GPBinaryClassifier, GPMulticlassClassifier,
                                               GPRegressor)
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import _build
from gaussian_process_tpu_torch.ops.cuda import chol as kchol
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops
from gaussian_process_tpu_torch.utils import checkpoint, datasets
from gaussian_process_tpu_torch.utils.logging import read_jsonl

BOOK = [66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19]
KERNEL_RTOL = 2e-4  # fp32 kernel vs plain: max abs err / max |plain|
# K2 vs float64 at the paths' shapes: max abs err / max |float64|, between
# 3xTF32's few 1e-6 and a 1xTF32 product's error
K2_F64_RTOL = 2e-5
GATE_MEAN, GATE_LML, GATE_VAR = 5e-4, 3e-4, 2e-3
N_EXACT, M_EXACT = 8192, 2048  # the exact path's training and test points
N_BIG, N_PARITY, D = 102400, 4096, 4  # the matrix-free path's sizes
# test points of the matrix-free runs, and the kernel each should reach:
# posterior_cg solves [y | K_s], so a kernel sees r = m + 1 columns
CG_RUNS = ((8, "gram_matvec_sym"), (64, "gram_matvec_full"))
MAIN_R = {name: m + 1 for m, name in CG_RUNS}
# other widths, checked and timed too: K3 at r = 1 (the binary Newton fit's
# width), r = 3 (the multi-class fit's) and 16 (one full pass), K2 at 72 and
# at 512 (the binary prediction's chunk)
EXTRA_R = (("gram_matvec_sym", 1), ("gram_matvec_sym", 3), ("gram_matvec_sym", 16),
           ("gram_matvec_full", 72), ("gram_matvec_full", 512))
# the widths phase 3 checks at n in {4096, 3001}; K3 only up to 64
CHECK_R = (1, 9, 16, 65, 72, 512)
# K3 at the classifiers' shape, d = 2 and RBF(1, 1): the Newton fits' widths
CLS_R = (1, 3)
# K2's instantiations at r = 65 (9 tiles of 8 columns) and r = 512 (passes
# of 16), compiled RBF at d <= 4, and the symmetric K4 sweep's at the
# training step's r = 9: their instruction mix is reported
K2_SASS = ("matvec_full_tc_kernel<9,4,1>", "matvec_full_tc_kernel<16,4,1>")
K4_SYM_SASS = ("matvec_bwd_sym_kernel<9,4,1>",)
# K3 against K2 on the same inputs, recorded for the sweep rule's gate
CROSS_R, CROSS_N = (9, 16, 33, 64), (4096, 102400)
SOURCES = {
    "gram": "gaussian_process_tpu_torch/csrc/gram.cu",
    "gram_ad": "gaussian_process_tpu_torch/csrc/gram.cu",
    "gram_ad_bwd": "gaussian_process_tpu_torch/csrc/gram_bwd.cu",
    "gram_matvec_sym": "gaussian_process_tpu_torch/csrc/gram_matvec_sym.cu",
    "gram_matvec_full": "gaussian_process_tpu_torch/csrc/gram_matvec_full.cuh",
    "gram_matvec_bwd": "gaussian_process_tpu_torch/csrc/gram_matvec_bwd.cu",
    "gram_matvec_bwd_sym": "gaussian_process_tpu_torch/csrc/gram_matvec_bwd_sym.cuh",
    "chol_inv_panel": "gaussian_process_tpu_torch/csrc/chol_panel.cu",
}
REPLACES = {
    "gram": "gaussian_process_tpu/ops/pallas/kernel_ops.py:141",
    "gram_ad": "gaussian_process_tpu/ops/pallas/kernel_ops.py:695",
    "gram_ad_bwd": "gaussian_process_tpu/ops/pallas/kernel_ops.py:695",
    "gram_matvec_sym": "gaussian_process_tpu/ops/pallas/kernel_ops.py:391",
    "gram_matvec_full": "gaussian_process_tpu/ops/pallas/kernel_ops.py:303",
    "gram_matvec_bwd": "gaussian_process_tpu/ops/pallas/kernel_ops.py:518",
    "gram_matvec_bwd_sym": "gaussian_process_tpu/ops/pallas/kernel_ops.py:518",
    "chol_inv_panel": "gaussian_process_tpu/ops/pallas/chol.py:155",
}
# K4 vs its plain version in float64: dL/dcoef per coefficient (fp32 entry
# products summed in float64), dL/dx as the forward's bound
BWD_COEF_RTOL = 1e-3
# the width a training step hands K4 ([alpha | z], 1 + 8 probes), and r = 1
BWD_R = (9, 1)
BWD_CHECK_N = (4096, 3001)  # K4's sweeps against the plain VJP
# the full K4 sweep's own path: the n = 4096 estimator, 64 probes
BWD_FULL_N, BWD_FULL_R = 4096, 65
GATE_PARAMS = 1e-3  # train_exact: rel params, fp32 vs float64
TRAIN_STEPS, TRAIN_PROBES, TRAIN_RANK = 3, 8, 2048
# K1 against the plain gram: KERNEL_RTOL, and the JAX package's absolute
# 1e-4 (bench.py, set on RBF(1, .) entries of at most 1) times
# max(1, max |plain|), since co2's book amplitude makes entries near 4.4e3
GRAM_ABS = 1e-4
GRAD_RTOL = 1e-3  # K5's gradients against the plain gram's in float64
# classification: the JAX laplace benches' shapes and gates
N_CLS, M_CLS, C_CLS = 4096, 2048, 3
N_NUMPY = 40000  # estimator_numpy: above the estimators' matrix-free threshold (32768)
CLS_CG_TOL, BIN_RANK, MC_RANK, BIN_CHUNK, MC_CHUNK = 1e-4, 512, 256, 512, 2048
GATE_PROB, GATE_LABELS = 5e-3, 0.999
# the blocked Cholesky: the JAX bench's chol mode (bench.py:555-614), RBF(1, 1)
# + noise on bench.py's _make_data, factored in panels of 1024
N_CHOL, BLOCK_CHOL, NOISE_CHOL = 10240, 1024, 5e-4
CHOL_PANELS = (1024, 96, 640)  # K6's checks besides the path's panel: b = 96 is ragged
CHOL_PANEL_RTOL = 1e-5  # K6 vs float64 (tests/test_blocked.py:166-167), where the plain meets it
# the segmented solver: phase 5's problem, m = 64 in chunks of 8, at most 2
# CG iterations a segment: the chunks after the first converge in 5-8
# iterations here (a segment of 6 left some chunks, chunk 3 among them,
# with one segment), so every chunk resumes mid-solve and the run stopped
# after the second segment of chunk 3 stops mid-solve. The segmented
# Laplace fit is stopped after 3 Newton steps.
SEG_M, SEG_CHUNK, SEG_ITERS, SEG_TOL, SEG_STOP_CHUNK, SEG_RANK = 64, 8, 2, 1e-3, 3, 2048
LAPLACE_STOP = 3
# CO2: the book hyperparameters, the reference's noise, 500 candidates a
# batch and a BO iteration, and the candidates held against the serial LML
THETA_BOOK = np.array(BOOK, dtype=np.float64)
CO2_NOISE, CO2_CANDIDATES, CO2_SERIAL = 5e-4, 500, 8
# the distributed phase: phase 5's problem at m = 64 (r = 65), segments of
# 6 iterations resumed from the checkpoints of segments 1 and 2, and 5
# training steps at n = 8192
DIST_M, DIST_TOL, DIST_RANK, DIST_SEG_ITERS, DIST_RESUME_FROM = 64, 1e-3, 2048, 6, (1, 2)
DIST_TRAIN_STEPS = 5
# the distributed classifiers (phase 17): K2 as a ring step calls it (x2
# given) at the Newton steps' width and at the prediction's, all m columns
# in one block-CG solve; the multi-host phase (18): 8 float64 candidates of
# the re-dispatched LML, one lost on the first attempt
RING_K2_R = (1, M_CLS)
MH_CANDIDATES, MH_LOST = 8, 3
# the H100 SXM's published peaks: fp32 outside the tensor cores, dense TF32
# on them, and HBM
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
# launches of each kernel on the main paths (each read just after its run)
PATH_LAUNCHES = {name: 0 for name in kops.launch_counts}


def add_launches(counts: dict) -> None:
    for name, value in counts.items():
        PATH_LAUNCHES[name] += value


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


def _kernel_name(mangled: str) -> str:
    """``matvec_full_tc_kernel<9,4,1>`` from nvcc's mangled name of a kernel in a
    source's anonymous namespace (``..._cu_<8 hex digits><length><name>``,
    then the template arguments); the mangled name if it is not one."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    end = m.end() + int(m.group(1))
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
    targs = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
    return mangled[m.end():end] + (f"<{','.join(targs)}>" if targs else "")


def _ptxas_usage(log: str) -> list:
    """Per kernel instantiation: registers, stack frame and spill bytes from
    ``nvcc -Xptxas -v``."""
    rows, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame and name:
            rows.append({"kernel": name, "stack": int(frame.group(1)),
                         "spill_stores": int(frame.group(2)),
                         "spill_loads": int(frame.group(3))})
        regs = re.search(r"Used (\d+) registers", line)
        if regs and rows and rows[-1]["kernel"] == name:
            rows[-1]["registers"] = int(regs.group(1))
    return rows


def _sass_mix(lib_path: str, kernels) -> dict:
    """Per kernel instantiation named in ``kernels``: its instructions in
    ``cuobjdump -sass`` of the built library, counted by opcode (the 12
    most frequent) and in all."""
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    ops_of, name = {}, None
    for line in text.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            name = _kernel_name(func.group(1))
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if ins and name in kernels:
            ops_of.setdefault(name, []).append(ins.group(2))
    return {k: {"total": len(v), **dict(collections.Counter(v).most_common(12))}
            for k, v in ops_of.items()}


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = str(_build.build())
    _build.load()
    seconds = time.perf_counter() - t0
    ptxas = _ptxas_usage(_build.build_info.get("ptxas", ""))
    emit("build", seconds=seconds, nvcc_seconds=_build.build_info.get("seconds"),
         ptxas=ptxas,
         # K1 and K5's backward: registers and spills of every instantiation
         gram_ptxas=[r for r in ptxas if r["kernel"].startswith("gram_kernel")],
         gram_bwd_ptxas=[r for r in ptxas if r["kernel"].startswith("gram_bwd_kernel")],
         k2_sass_mix=_sass_mix(lib_path, K2_SASS),
         k4_sym_sass_mix=_sass_mix(lib_path, K4_SYM_SASS))


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


def _run(name: str, kernel, params, x, v, dot_mode: str = "split3"):
    sym = name == "gram_matvec_sym"
    return kops.gram_matvec(kernel, params, x, None, v, symmetric=sym, dot_mode=dot_mode)


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
    sweeps = [("gram_matvec_sym", "split3"), *[("gram_matvec_full", m) for m in kops.DOT_MODES]]
    for n in (4096, 3001):
        x = torch.tensor(gen.uniform(-5, 5, (n, D)), dtype=torch.float32, device=device)
        for r in CHECK_R:
            v = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=device)
            for name, mode in sweeps:
                if name == "gram_matvec_sym" and r > 64:
                    continue
                for family, (kernel, params) in cases.items():
                    before = kops.launch_counts[name]
                    got = _run(name, kernel, params, x, v, mode)
                    torch.cuda.synchronize()
                    require(kops.launch_counts[name] == before + 1, f"{name} launched")
                    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
                    err, scale = _max_err(got, want)
                    checked.append([name, mode, family, n, r, err, scale])
        # the full sweep with a second point set (x2 given)
        x2 = torch.tensor(gen.uniform(-5, 5, (n // 2 + 7, D)), dtype=torch.float32,
                          device=device)
        v2 = torch.tensor(gen.standard_normal((x2.shape[0], 9)), dtype=torch.float32,
                          device=device)
        kernel, params = cases["matern52"]
        for mode in kops.DOT_MODES:
            got = kops.gram_matvec(kernel, params, x, x2, v2, dot_mode=mode)
            err, scale = _max_err(got, kops.gram_matvec_reference(kernel, params, x, x2, v2))
            checked.append(["gram_matvec_full", mode, "matern52_cross", n, 9, err, scale])
    emit("kernels_vs_plain", tolerance=f"max abs err <= {KERNEL_RTOL} x max|plain|",
         columns=["kernel", "dot_mode", "family", "n", "r", "max_abs_err", "max_abs_plain"],
         cases=checked)

    # at the main path's shapes: n = 102400, r = 9 (K3) and r = 65 (K2), as
    # the dispatch rule picks them; then the other widths
    require(all(kops.use_symmetric(N_BIG, r) == (name == "gram_matvec_sym")
                for name, r in MAIN_R.items()), "main-path widths reach their kernels")
    kernel, params = cases["rbf"]
    x = torch.tensor(gen.uniform(-5, 5, (N_BIG, D)), dtype=torch.float32, device=device)
    timings, extra = {}, []
    repeat = breakdown = None
    for name, r in [*MAIN_R.items(), *EXTRA_R]:
        v = torch.tensor(gen.standard_normal((N_BIG, r)), dtype=torch.float32, device=device)
        row, got = _matvec_timed(name, kernel, params, x, v)
        if name == "gram_matvec_sym" and r == MAIN_R[name]:
            # the fixed-point sum: a second run gives the same bits
            again = _run(name, kernel, params, x, v)
            repeat = {"r": r, "bitwise_equal": bool(torch.equal(got, again)),
                      "max_abs_diff": float(torch.max(torch.abs(got - again)))}
            require(repeat["bitwise_equal"], f"K3 twice at n = {N_BIG}, r = {r}: equal bits")
            # device time by kernel: the sweep, its finishing pass, the scales
            breakdown = _device_breakdown(lambda: _run(name, kernel, params, x, v))
        if name in timings:
            extra.append(row)
        else:
            timings[name] = row
    # the classifiers' shape
    kernel2, params2 = ops.RBF(), convert.params_from_numpy(
        {"sigma": 1.0, "lengthscale": 1.0}, device=device, dtype=torch.float32)
    x2 = torch.tensor(gen.uniform(-3, 3, (N_BIG, 2)), dtype=torch.float32, device=device)
    classifiers = []
    for r in CLS_R:
        v = torch.tensor(gen.standard_normal((N_BIG, r)), dtype=torch.float32, device=device)
        classifiers.append(_matvec_timed("gram_matvec_sym", kernel2, params2, x2, v)[0])
    emit("kernels_timed", kernel="RBF(sigma=1, lengthscale=2)", main_path=timings,
         other_widths=extra, k3_repeat=repeat, k3_device_breakdown=breakdown,
         classifier_shape={"kernel": "RBF(sigma=1, lengthscale=1)", "d": 2,
                           "rows": classifiers})

    # K3 against K2 on the same inputs (symmetric forced either way): where
    # the sweeps cross, recorded only; the dispatch rule stays the JAX one's
    crossover = []
    for n in CROSS_N:
        xn = x[:n]
        for r in CROSS_R:
            v = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=device)
            reps = 20 if n < N_BIG else 2
            sym = lambda: _run("gram_matvec_sym", kernel, params, xn, v)
            full = lambda: _run("gram_matvec_full", kernel, params, xn, v)
            full_a, sym_a, sym_b, full_b = (_time_ms(f, reps) for f in (full, sym, sym, full))
            crossover.append({"n": n, "r": r, "k3_ms": min(sym_a, sym_b),
                              "k2_ms": min(full_a, full_b),
                              "use_symmetric": kops.use_symmetric(n, r)})
    emit("k3_k2_crossover", kernel="RBF(sigma=1, lengthscale=2)", d=D, rows=crossover)
    return timings


def _matvec_timed(name, kernel, params, x, v):
    """A forward sweep at the paths' shapes against its plain version, then
    both timed in turns (plain, kernel, kernel, plain): (row, output). K2 is
    also run twice for equal bits and held against float64
    (``rel_err_f64`` <= K2_F64_RTOL), with the plain version's 1xTF32
    product (:func:`_tf32_product`) against float64 recorded beside it."""
    n, d = x.shape
    r = v.shape[1]
    got = _run(name, kernel, params, x, v)
    want = kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
    err, scale = _max_err(got, want)
    plain = lambda: kops.gram_matvec_reference(kernel, params, x, None, v, same=True)
    run = lambda: _run(name, kernel, params, x, v)
    if name == "gram_matvec_sym":
        row = _in_turns(run, plain, 5, 3)
        # K3 evaluates the upper triangle once and applies each entry twice
        row.update(_bound(n * (n + 1) / 2 * _entry_flops(d) + n ** 2 * 2 * r,
                          (n * d + 2 * n * r) * 4))
    else:
        again = run()
        row = _in_turns(run, plain, *((2, 2) if r > 128 else (5, 3)))
        # against float64, relative to its largest entry
        p64 = tk.tree_map_params(lambda a: a.double(), params)
        want64 = kops.gram_matvec_reference(kernel, p64, x.double(), None, v.double(),
                                            same=True)
        scale64 = float(torch.max(torch.abs(want64)))
        rel64 = lambda out: float(torch.max(torch.abs(out.double() - want64))) / scale64
        row.update(rel_err_f64=rel64(got),
                   tf32_control_rel_err_f64=rel64(_tf32_product(kernel, params, x, v)),
                   bitwise_equal=bool(torch.equal(got, again)), columns=kops.full_columns(r))
        del want64
        require(row["bitwise_equal"], f"K2 twice at n = {n}, r = {r}: equal bits")
        require(row["rel_err_f64"] <= K2_F64_RTOL,
                f"K2 at n = {n}, r = {r}: {row['rel_err_f64']:.3e} of max |float64| "
                f"within {K2_F64_RTOL}")
        row.update(_bound_k2(n, n, d, r))
    row.update(kernel=name, n=n, d=d, r=r, max_abs_err=err, max_abs_plain=scale)
    return row, got


def _tf32_product(kernel, params, x, v, row_chunk: int = 4096) -> torch.Tensor:
    """The plain version K(x, x) @ v with its output product in 1xTF32
    (cuBLAS with TF32 matmuls; the entries in fp32, as the plain version
    forms them): the control that K2's float64 gate must tell apart."""
    flag = torch.backends.cuda.matmul.allow_tf32
    out = torch.empty((x.shape[0], v.shape[1]), dtype=torch.float32, device=x.device)
    try:
        for i in range(0, x.shape[0], row_chunk):
            torch.backends.cuda.matmul.allow_tf32 = flag
            K = tk.gram(kernel, params, x[i:i + row_chunk], x)
            torch.backends.cuda.matmul.allow_tf32 = True
            out[i:i + row_chunk] = K @ v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    return out


def _gram_err(got: torch.Tensor, want: torch.Tensor):
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    require(np.isfinite(err) and err <= KERNEL_RTOL * scale
            and err < GRAM_ABS * max(1.0, scale),
            f"K1 error {err:.3e} within {KERNEL_RTOL} x {scale:.3e} and "
            f"{GRAM_ABS} x max(1, {scale:.3e})")
    return err, scale


def _gram_launch(kernel, params, x1, x2):
    """K1's launch alone (program, coefficients and centred inputs made
    beforehand), as ``_GramFn``'s forward makes it."""
    program, coefs, white_idx = kops.gram_program(kernel, params, x2 is None)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=x1.device)
    x1c, x2c = _centred(x1, x2)
    return lambda: kops.gram_cuda(program, coef, x1c, None if x2 is None else x2c,
                                  white_idx=white_idx, need_l2=tk.needs_l2(kernel))


def _queued_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls enqueued behind a device
    sleep of 2e8 clocks (about 0.1 s), so the card runs them back to back
    however long the host takes to launch each (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(run, plain, reps: int, plain_reps: int, timer=_time_ms):
    """plain, kernel, kernel, plain: (best kernel ms, best plain ms, runs);
    the kernel timed by ``timer``."""
    plain_a = _time_ms(plain, plain_reps)
    ms_a = timer(run, reps)
    ms_b = timer(run, reps)
    plain_b = _time_ms(plain, plain_reps)
    return {"ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
            "ms_runs": [ms_a, ms_b], "plain_ms_runs": [plain_a, plain_b]}


def _gram_ad_check(device, gen: np.random.Generator) -> dict:
    """K5: gradients of sum(W * gram_ad) (K1's forward, one launch of the
    backward kernel per backward) against autograd through the plain gram
    in float64, for RBF + Matern 5/2 at n = 4096, d = 3: the params
    same-set, the params and both point sets cross-set; then the same-set
    x-gradient, where autograd through the plain gram puts sqrt at zero on
    the diagonal (NaN): finite, and against the float64 plain VJP, whose
    coincident pairs add nothing, as the kernel's."""
    kernel = ops.RBF() + ops.Matern(nu=2.5)
    base = convert.params_from_numpy(({"sigma": 1.0, "lengthscale": 1.5},
                                      {"sigma": 0.7, "lengthscale": 2.0}), device=device)
    n = N_PARITY
    x1 = torch.tensor(gen.uniform(-3, 3, (n, 3)), dtype=torch.float32, device=device)
    x2 = torch.tensor(gen.uniform(-3, 3, (n, 3)), dtype=torch.float32, device=device)
    w = torch.tensor(gen.standard_normal((n, n)), dtype=torch.float32, device=device)
    rows = []
    for same in (True, False):
        def grads(dtype, fn):
            p = tk.tree_map_params(lambda a: a.detach().to(dtype).requires_grad_(True), base)
            a = x1.detach().to(dtype).requires_grad_(not same)
            b = None if same else x2.detach().to(dtype).requires_grad_(True)
            inputs = tk.tree_leaves(p) + ([] if same else [a, b])
            return torch.autograd.grad(torch.sum(w.to(dtype) * fn(kernel, p, a, b)), inputs)

        before = dict(kops.launch_counts)
        got = grads(torch.float32, kops.gram_ad)
        torch.cuda.synchronize()
        require(kops.launch_counts["gram_ad"] == before["gram_ad"] + 1, "gram_ad launched K1")
        require(kops.launch_counts["gram_ad_bwd"] == before["gram_ad_bwd"] + 1,
                "one K5 backward launch per backward")
        want = grads(torch.float64, kops.gram_reference)
        errs = [float(torch.max(torch.abs(g.double() - r)) / torch.max(torch.abs(r)))
                for g, r in zip(got, want)]
        abs_err = max(float(torch.max(torch.abs(g.double() - r))) for g, r in zip(got, want))
        require(max(errs) <= GRAD_RTOL, f"K5 gradients within {GRAD_RTOL} (got {max(errs):.3e})")
        rows.append({"same": same, "n": n, "rel_errs": errs, "max_abs_err": abs_err})

    a = x1.detach().requires_grad_(True)
    before = kops.launch_counts["gram_ad_bwd"]
    (got,) = torch.autograd.grad(torch.sum(w * kops.gram_ad(kernel, base, a)), [a])
    torch.cuda.synchronize()
    require(kops.launch_counts["gram_ad_bwd"] == before + 1, "one K5 backward launch")
    p64 = tk.tree_map_params(lambda t: t.double(), base)
    program, coefs, white_idx = kops.gram_program(kernel, p64, True)
    xc, _ = _centred(x1.double(), None)
    _, want, _ = kops.gram_vjp_reference(
        program, kops.coef_vector(coefs, dtype=torch.float64, device=device), xc, None,
        w.double(), white_idx=white_idx, need_l2=True, want_dx1=True)
    err, scale = float(torch.max(torch.abs(got.double() - want))), float(torch.max(torch.abs(want)))
    require(bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale,
            f"same-set Matern x-gradient finite, within {KERNEL_RTOL} x {scale:.3e} "
            f"(got {err:.3e})")
    rows.append({"same": True, "n": n, "x_gradient": True, "rel_err": err / scale,
                 "max_abs_err": err})
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def _gram_bwd_timed(device, gen: np.random.Generator) -> dict:
    """K5's backward alone at the exact-training shape, n = 8192, d = 4,
    RBF(1, 2), same set: params only (a training step's) and with dx, each
    against the float64 plain VJP (dL/dcoef within BWD_COEF_RTOL per
    coefficient, dL/dx within KERNEL_RTOL x max |plain|), run twice for
    equal bits, then timed in turns with the plain version in fp32, beside
    ``torch.sum`` of the cotangent (the read rate a library reduction
    reaches on the same bytes)."""
    n, d = N_EXACT, D
    x = torch.tensor(gen.uniform(-5, 5, (n, d)), dtype=torch.float32, device=device)
    ct = torch.tensor(gen.standard_normal((n, n)), dtype=torch.float32, device=device)
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 2.0}, device=device,
                                       dtype=torch.float32)
    program, coefs, white_idx = kops.gram_program(ops.RBF(), params, True)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=device)
    xc, _ = _centred(x, None)
    rows = []
    for want_dx in (False, True):
        args = (program, coef, xc, None, ct)
        kw = dict(white_idx=white_idx, need_l2=False, want_dx1=want_dx)
        run = lambda: kops.gram_bwd_cuda(*args, **kw)  # noqa: E731
        got, again = run(), run()
        want = kops.gram_vjp_reference(program, coef.double(), xc.double(), None, ct.double(),
                                       **kw)
        coef_rel = float(torch.max(torch.abs(got[0].double() - want[0]) / torch.abs(want[0])))
        require(coef_rel <= BWD_COEF_RTOL,
                f"K5 backward dL/dcoef within {BWD_COEF_RTOL} (got {coef_rel:.3e})")
        require(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
                "K5 backward twice: equal bits")
        row = {"dx": want_dx, "coef_rel_err": coef_rel,
               "max_abs_err": float(torch.max(torch.abs(got[0].double() - want[0])))}
        if want_dx:
            err, scale = (float(torch.max(torch.abs(got[1].double() - want[1]))),
                          float(torch.max(torch.abs(want[1]))))
            require(err <= KERNEL_RTOL * scale, f"K5 backward dL/dx within {KERNEL_RTOL} x "
                    f"{scale:.3e} (got {err:.3e})")
            row["dx_rel_err"] = err / scale
        del want
        plain = lambda: kops.gram_vjp_reference(*args, **kw)  # noqa: E731
        # calls launched one after another are bound by the wrapper's host
        # work (a launch and about ten small torch ops, call_ms) where the
        # card needs less: ms is the card's time per call, the kernel and
        # its finishing ops, with the calls queued
        row.update(_in_turns(run, plain, 20, 3, timer=_queued_ms))
        row["call_ms"] = _time_ms(run, 20)
        # ct read once, x read, dx written; an entry, its two sums (and 4d
        # FMAs of the x-gradient's row and column sums)
        row.update(_bound(n * n * (_entry_flops(d) + 4 + (4 * d if want_dx else 0)),
                          (n * n + n * d + (n * d if want_dx else 0)) * 4))
        row["read_yardstick_ms"] = _time_ms(lambda: torch.sum(ct), 20)
        row.update(kernel="gram_ad_bwd", n=n, m=n, d=d)
        rows.append(row)
    emit("kernels_gram_bwd_timed", kernel="RBF(sigma=1, lengthscale=2)",
         plain="gram_vjp_reference in fp32", yardstick="torch.sum(ct)", rows=rows)
    return rows[0]


def phase_kernels_gram(device, gen: np.random.Generator) -> dict:
    """K1 against ``ops.gram`` on the card, timed at the paths' shapes;
    then K5's gradients and its forward + backward time."""
    co2 = ops.co2_kernel()
    f32 = lambda p: convert.params_from_numpy(p, device=device, dtype=torch.float32)
    rbf_white = (ops.RBF() + ops.White(), f32(({"sigma": 1.0, "lengthscale": 2.0},
                                               {"amplitude": 0.1})))
    cases = [
        ("rbf_white_same", *rbf_white, N_EXACT, None, D),
        ("co2_no_white_cross", ops.Sum(children=co2.children[:4]),
         f32(ops.co2_params_from_vector(torch.tensor(BOOK, dtype=torch.float64))[:4]),
         N_BIG, BIN_CHUNK, 2),
        ("matern52_same_ragged", ops.Matern(nu=2.5), f32({"sigma": 1.2, "lengthscale": 1.5}),
         3001, None, D),
    ]
    checked = []
    for name, kernel, params, n, m, d in cases:
        x1 = torch.tensor(gen.uniform(-5, 5, (n, d)), dtype=torch.float32, device=device)
        x2 = None if m is None else torch.tensor(gen.uniform(-5, 5, (m, d)),
                                                 dtype=torch.float32, device=device)
        before = kops.launch_counts["gram"]
        got = kops.gram(kernel, params, x1, x2)
        torch.cuda.synchronize()
        require(kops.launch_counts["gram"] == before + 1, "the dispatcher launched K1")
        err, scale = _gram_err(got, kops.gram_reference(kernel, params, x1, x2))
        checked.append({"case": name, "n": n, "m": m or n, "d": d, "max_abs_err": err,
                        "max_abs_plain": scale})
    emit("kernels_gram_vs_plain", tolerance=f"max abs err <= {KERNEL_RTOL} x max|plain| and "
         f"< {GRAM_ABS} x max(1, max|plain|)", cases=checked)

    # the paths' shapes: the exact path's K (RBF(1, 2), d = 4) and the
    # classifiers' cross-gram chunks (RBF(1, 1), d = 2)
    timed = []
    for n, m, d, lengthscale in ((N_EXACT, None, D, 2.0), (N_BIG, BIN_CHUNK, 2, 1.0),
                                 (N_BIG, MC_CHUNK, 2, 1.0)):
        kernel, params = ops.RBF(), f32({"sigma": 1.0, "lengthscale": lengthscale})
        x1 = torch.tensor(gen.uniform(-3, 3, (n, d)), dtype=torch.float32, device=device)
        x2 = None if m is None else torch.tensor(gen.uniform(-3, 3, (m, d)),
                                                 dtype=torch.float32, device=device)
        launch = _gram_launch(kernel, params, x1, x2)
        err, scale = _gram_err(launch(), kops.gram_reference(kernel, params, x1, x2))
        row = _in_turns(launch, lambda: kops.gram_reference(kernel, params, x1, x2), 20, 5)
        entries = n * (m or n)
        out = torch.empty((n, m or n), dtype=torch.float32, device=device)
        row.update(kernel="gram", n=n, m=m or n, d=d, max_abs_err=err,
                   **_bound(entries * _entry_flops(d), (entries + (n + (m or 0)) * d) * 4),
                   dispatcher_ms=_time_ms(lambda: kops.gram(kernel, params, x1, x2), 20),
                   fill_ms=_time_ms(lambda: out.fill_(0.0), 20))
        del out
        timed.append(row)
    emit("kernels_gram_timed", kernel="RBF(sigma=1)", plain="ops.gram in fp32",
         yardstick="fill_ of the same bytes", rows=timed)

    check = _gram_ad_check(device, gen)
    bwd = _gram_bwd_timed(device, gen)
    # forward + params backward at the exact-training shape
    x = torch.tensor(gen.uniform(-5, 5, (N_EXACT, D)), dtype=torch.float32, device=device)
    w = torch.tensor(gen.standard_normal((N_EXACT, N_EXACT)), dtype=torch.float32,
                     device=device)
    params = {k: v.requires_grad_(True) for k, v in
              f32({"sigma": 1.0, "lengthscale": 2.0}).items()}

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(torch.sum(w * fn(ops.RBF(), params, x)),
                                           list(params.values()))

    row = _in_turns(fwd_bwd(kops.gram_ad), fwd_bwd(kops.gram_reference), 10, 10)
    # the same with the calls queued: the card's time, without the host's
    row["queued_ms"] = _queued_ms(fwd_bwd(kops.gram_ad), 10)
    # the function is (x, params, w) -> two gradients: w is read once, and
    # each entry costs its evaluation and about four flops of its VJP
    row.update(kernel="gram_ad", n=N_EXACT, d=D, max_abs_err=check["max_abs_err"],
               **_bound(N_EXACT ** 2 * (_entry_flops(D) + 4), (N_EXACT ** 2 + N_EXACT * D) * 4))
    emit("gram_ad_check", tolerance=f"gradient max abs err <= {GRAD_RTOL} x max|float64 plain|",
         kernel="RBF + Matern(5/2)", rows=check["rows"], timed_forward_backward=row)
    return {"gram": timed[0], "gram_ad": row, "gram_ad_bwd": bwd}


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
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model, mean, std = serve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kops.launch_counts)
    add_launches(counts)

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
         gates={"mean": GATE_MEAN, "lml": GATE_LML, "var": GATE_VAR}, launches=counts)
    require(rel_mean <= GATE_MEAN and rel_lml <= GATE_LML and rel_var <= GATE_VAR,
            "exact path within the parity gates")
    require(counts["gram"] > 0 and counts["gram_ad"] > 0, "the exact path launched K1 and K5")


def _cg_problem(device, gen: np.random.Generator, n: int):
    x = torch.tensor(gen.uniform(-5.0, 5.0, (n, D)), dtype=torch.float32, device=device)
    noise = 0.02 * torch.tensor(gen.standard_normal(n), dtype=torch.float32, device=device)
    y = torch.sin(0.9 * x.sum(dim=1)) + noise
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 2.0}, device=device,
                                       dtype=torch.float32)
    return x, y, params


def phase_matrix_free(device, gen: np.random.Generator) -> None:
    kernel = ops.RBF()
    x, y, params = _cg_problem(device, gen, N_BIG)
    tol, noise = 1e-3, 1e-2
    runs = {}
    for m, expect in (*CG_RUNS, CG_RUNS[0]):  # the symmetric-sweep run twice
        xs = x[:m] + 0.1
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        post = gp.posterior_cg(kernel, params, x, y, xs, noise_variance=noise, tol=tol,
                               max_iters=120, preconditioner="nystrom", precond_rank=2048)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(kops.launch_counts)
        add_launches(counts)
        runs.setdefault(m, []).append(post)
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

    # K3's fixed-point sum makes the whole solve repeat itself bit for bit
    first, second = runs[CG_RUNS[0][0]]
    same = {"iters": [first.iters, second.iters],
            "mean_bitwise_equal": bool(torch.equal(first.mean, second.mean)),
            "var_bitwise_equal": bool(torch.equal(first.var, second.var))}
    emit("matrix_free_repeat", n=N_BIG, m=CG_RUNS[0][0], **same)
    require(first.iters == second.iters and same["mean_bitwise_equal"]
            and same["var_bitwise_equal"], "posterior_cg twice: equal iterations and bits")

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


def _centred(x1, x2):
    c = torch.mean(x1, dim=0, keepdim=True)
    x1c = (x1 - c).contiguous()
    return x1c, (x1c if x2 is None else (x2 - c).contiguous())


def _bwd_check(kernel, params, x1c, x2c, v, ct, want_dx, sweep="gram_matvec_bwd"):
    """One of K4's sweeps (``sweep``: the full one, or the symmetric one,
    same-set without dx) once against the float64 plain VJP on the same
    (fp32) inputs; returns the errors."""
    program, coefs = kops.encode(kernel, params)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device=x1c.device)
    need_l2 = tk.needs_l2(kernel)
    before = kops.launch_counts[sweep]
    if sweep == "gram_matvec_bwd_sym":
        require(x1c is x2c and not want_dx, "the symmetric sweep: same set, no dx")
        d_coef = kops.matvec_bwd_sym_cuda(program, coef, x1c, v, ct, need_l2=need_l2)
        d_x = None
    else:
        d_coef, d_x = kops.matvec_bwd_cuda(program, coef, x1c, x2c, v, ct, need_l2=need_l2,
                                           want_dx=want_dx)
    torch.cuda.synchronize()
    require(kops.launch_counts[sweep] == before + 1, f"{sweep} launched")
    want, want_dx_ = kops.gram_matvec_vjp_reference(
        program, kops.coef_vector(coefs, dtype=torch.float64, device=x1c.device),
        x1c.double(), x2c.double(), v.double(), ct.double(), need_l2=need_l2, want_dx=want_dx)
    rel = torch.abs(d_coef.double() - want) / torch.abs(want)
    coef_err = float(torch.max(rel))
    require(np.isfinite(coef_err) and coef_err <= BWD_COEF_RTOL,
            f"{sweep} dL/dcoef within {BWD_COEF_RTOL} (got {coef_err:.3e})")
    out = {"coef_rel_err": coef_err,
           "coef_abs_err": float(torch.max(torch.abs(d_coef.double() - want)))}
    if want_dx:
        err, scale = _max_err(d_x.double(), want_dx_)
        out.update(dx_abs_err=err, dx_max_abs_plain=scale)
    return out, (program, coef, need_l2)


def _grad_fault_repro(device, gen, cases) -> list:
    """The params gradient through the CUDA gram_matvec (the autograd
    Function, whose backward launches K4's symmetric sweep here: same set,
    n >= 2048, no dx) against autograd through the plain version in
    float64: it must equal it, not be zero."""
    rows = []
    n = 3001
    x = torch.tensor(gen.uniform(-5, 5, (n, D)), dtype=torch.float32, device=device)
    v = torch.tensor(gen.standard_normal((n, 8)), dtype=torch.float32, device=device)
    w = torch.tensor(gen.standard_normal((n, 8)), dtype=torch.float32, device=device)
    for family in ("rbf", "co2_no_white"):
        kernel, params = cases[family]
        p32 = tk.tree_map_params(lambda a: a.detach().clone().requires_grad_(True), params)
        p64 = tk.tree_map_params(lambda a: a.detach().double().requires_grad_(True), params)
        before = dict(kops.launch_counts)
        loss = torch.sum(w * kops.gram_matvec(kernel, p32, x, None, v))
        got = torch.autograd.grad(loss, tk.tree_leaves(p32))
        torch.cuda.synchronize()
        require(kops.launch_counts["gram_matvec_bwd_sym"] == before["gram_matvec_bwd_sym"] + 1
                and kops.launch_counts["gram_matvec_bwd"] == before["gram_matvec_bwd"],
                "the params gradient went through K4's symmetric sweep")
        ref = torch.sum(w.double() * kops.gram_matvec_reference(
            kernel, p64, x.double(), None, v.double(), same=True))
        want = torch.autograd.grad(ref, tk.tree_leaves(p64))
        errs = [float(abs(g.double() - r) / abs(r)) for g, r in zip(got, want)]
        require(all(float(g) != 0.0 for g in got), f"{family}: nonzero params gradient")
        require(max(errs) <= BWD_COEF_RTOL, f"{family}: params gradient within "
                f"{BWD_COEF_RTOL} of the plain version's (got {max(errs):.3e})")
        rows.append({"family": family, "max_rel_err": max(errs),
                     "grad": [float(g) for g in got], "plain_grad": [float(r) for r in want]})
    return rows


def phase_kernels_bwd(device, gen: np.random.Generator) -> dict:
    cases = _case_kernels(device)
    checked = []
    for n in BWD_CHECK_N:
        x = torch.tensor(gen.uniform(-5, 5, (n, D)), dtype=torch.float32, device=device)
        x2 = torch.tensor(gen.uniform(-5, 5, (n // 2 + 7, D)), dtype=torch.float32,
                          device=device)
        for r in (1, 8, 9):
            for same in (True, False):
                x1c, x2c = _centred(x, None if same else x2)
                m = x2c.shape[0]
                v = torch.tensor(gen.standard_normal((m, r)), dtype=torch.float32,
                                 device=device)
                ct = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32,
                                  device=device)
                sweeps = [("gram_matvec_bwd", False), ("gram_matvec_bwd", True)]
                if same:
                    sweeps.append(("gram_matvec_bwd_sym", False))
                for family, (kernel, params) in cases.items():
                    for sweep, want_dx in sweeps:
                        errs, _ = _bwd_check(kernel, params, x1c, x2c, v, ct, want_dx, sweep)
                        checked.append({"kernel": sweep, "family": family, "n": n, "m": m,
                                        "r": r, "same": same, "dx": want_dx, **errs})
    emit("kernels_bwd_vs_plain",
         tolerance=f"dL/dcoef rel <= {BWD_COEF_RTOL} per coefficient (plain in float64); "
                   f"dL/dx abs <= {KERNEL_RTOL} x max|plain|",
         worst_coef_rel_err={k: max(c["coef_rel_err"] for c in checked if c["kernel"] == k)
                             for k in ("gram_matvec_bwd", "gram_matvec_bwd_sym")},
         cases=len(checked), rows=checked)
    emit("grad_fault_repro", rows=_grad_fault_repro(device, gen, cases))

    # at the training step's shape: n = 102400, RBF(1, 2), no x-gradient;
    # both sweeps on the same inputs, in turns (plain, full, symmetric,
    # symmetric, full, plain)
    kernel, params = cases["rbf"]
    x = torch.tensor(gen.uniform(-5, 5, (N_BIG, D)), dtype=torch.float32, device=device)
    x1c, _ = _centred(x, None)
    rows = []
    for r in BWD_R:
        v = torch.tensor(gen.standard_normal((N_BIG, r)), dtype=torch.float32, device=device)
        ct = torch.tensor(gen.standard_normal((N_BIG, r)), dtype=torch.float32, device=device)
        errs, (program, coef, need_l2) = _bwd_check(kernel, params, x1c, x1c, v, ct, False)
        sym_errs, _ = _bwd_check(kernel, params, x1c, x1c, v, ct, False, "gram_matvec_bwd_sym")
        full = lambda: kops.matvec_bwd_cuda(program, coef, x1c, x1c, v, ct, need_l2=need_l2,
                                            want_dx=False)
        sym = lambda: kops.matvec_bwd_sym_cuda(program, coef, x1c, v, ct, need_l2=need_l2)
        plain = lambda: kops.gram_matvec_vjp_reference(program, coef, x1c, x1c, v, ct,
                                                       need_l2=need_l2, want_dx=False)
        again = sym()
        plain_a, full_a = _time_ms(plain, 1), _time_ms(full, 3)
        sym_a, sym_b = _time_ms(sym, 5), _time_ms(sym, 5)
        full_b, plain_b = _time_ms(full, 3), _time_ms(plain, 1)
        plain_ms = min(plain_a, plain_b)
        # per entry: the evaluation, the leaf's derivatives (about six
        # flops), the G entry (2 r) and the coefficient sums (4); the
        # symmetric sweep's n (n + 1) / 2 pairs each take a 2 r-term pair
        # weight (4 r)
        rows.append({"kernel": "gram_matvec_bwd", "n": N_BIG, "r": r, **errs,
                     "max_abs_err": errs["coef_abs_err"], "ms": min(full_a, full_b),
                     "plain_ms": plain_ms, "ms_runs": [full_a, full_b],
                     "plain_ms_runs": [plain_a, plain_b],
                     **_bound(N_BIG ** 2 * (_entry_flops(D) + 6 + 2 * r + 4),
                              (N_BIG * D + 2 * N_BIG * r) * 4)})
        rows.append({"kernel": "gram_matvec_bwd_sym", "n": N_BIG, "r": r, **sym_errs,
                     "max_abs_err": sym_errs["coef_abs_err"], "ms": min(sym_a, sym_b),
                     "plain_ms": plain_ms, "ms_runs": [sym_a, sym_b],
                     "plain_ms_runs": [plain_a, plain_b],
                     "full_sweep_ms": min(full_a, full_b),
                     "passes_width": list(kops.bwd_sym_passes(r)),
                     "bitwise_equal": bool(torch.equal(sym(), again)),
                     **_bound(N_BIG * (N_BIG + 1) / 2 * (_entry_flops(D) + 6 + 4 * r + 4),
                              (N_BIG * D + 2 * N_BIG * r) * 4)})
        require(rows[-1]["bitwise_equal"], f"the symmetric K4 sweep twice at r = {r}: equal bits")
    # the full sweep at its own path's shape (the n = 4096 estimator)
    n, r = BWD_FULL_N, BWD_FULL_R
    xf = torch.tensor(gen.uniform(-5, 5, (n, D)), dtype=torch.float32, device=device)
    x1c, _ = _centred(xf, None)
    v = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=device)
    ct = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=device)
    errs, (program, coef, need_l2) = _bwd_check(kernel, params, x1c, x1c, v, ct, False)
    row = _in_turns(lambda: kops.matvec_bwd_cuda(program, coef, x1c, x1c, v, ct,
                                                 need_l2=need_l2, want_dx=False),
                    lambda: kops.gram_matvec_vjp_reference(program, coef, x1c, x1c, v, ct,
                                                           need_l2=need_l2, want_dx=False),
                    20, 5)
    row.update(kernel="gram_matvec_bwd", n=n, r=r, **errs, max_abs_err=errs["coef_abs_err"],
               **_bound(n ** 2 * (_entry_flops(D) + 6 + 2 * r + 4), (n * D + 2 * n * r) * 4))
    emit("kernels_bwd_timed", kernel="RBF(sigma=1, lengthscale=2)", plain="fp32 plain VJP",
         rows=rows, full_sweep_path_shape=row)
    return {"gram_matvec_bwd": row,
            "gram_matvec_bwd_sym": next(t for t in rows if t["kernel"] == "gram_matvec_bwd_sym"
                                        and t["r"] == BWD_R[0])}


def _rel_params(a, b) -> float:
    return max(abs(float(a[k]) - float(b[k])) / abs(float(b[k])) for k in b)


def phase_train_exact(device, gen: np.random.Generator):
    n = N_EXACT
    x = gen.uniform(-5.0, 5.0, (n, D))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * gen.standard_normal(n)
    fit = dict(optimize=True, max_iters=50, optimizer="adam", transform="log")

    def train(dtype, **overrides):
        model = GPRegressor(ops.RBF(), noise_variance=5e-4, device=device)
        lml0 = float(gp.log_marginal_likelihood(
            ops.RBF(), convert.params_from_numpy(model.params, device=device),
            torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device), noise_variance=5e-4))
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype),
                  **{**fit, **overrides})
        torch.cuda.synchronize()
        return model, lml0, time.perf_counter() - t0

    # warm-up: the first backward through the float64 Cholesky loads its
    # kernels and handles (on an H100 the first 50-step run took 10.5 s,
    # the next 3.5 s)
    for dtype in (torch.float32, torch.float64):
        train(dtype, max_iters=2)
    # the dense grams whose output autograd differentiates: each must get
    # exactly one launch of K5's backward
    differentiated, real_gram_ad = [0], kops.gram_ad

    def counted_gram_ad(*args, **kwargs):
        out = real_gram_ad(*args, **kwargs)
        differentiated[0] += int(out.requires_grad)
        return out

    kops.gram_ad = counted_gram_ad
    try:
        model, lml0, seconds = train(torch.float32)
    finally:
        kops.gram_ad = real_gram_ad
    counts = dict(kops.launch_counts)
    add_launches(counts)
    ref, ref_lml0, ref_seconds = train(torch.float64)
    lml, ref_lml = float(model.lml_), float(ref.lml_)
    rel_lml = abs(lml - ref_lml) / abs(ref_lml)
    rel_params = _rel_params(model.params, ref.params)
    emit("train_exact", n=n, d=D, dtype="float32", iters=50, optimizer="adam",
         transform="log", seconds=seconds, seconds_float64=ref_seconds,
         lml_start=lml0, lml=lml, lml_float64=ref_lml, rel_lml=rel_lml,
         params={k: float(v) for k, v in model.params.items()},
         params_float64={k: float(v) for k, v in ref.params.items()},
         rel_params=rel_params, gates={"lml": GATE_LML, "params": GATE_PARAMS},
         launches=counts, differentiated_grams=differentiated[0])
    require(np.isfinite(lml) and lml > lml0, "exact training raised the LML")
    require(counts["gram"] > 0 and counts["gram_ad"] > 0, "exact training launched K1 and K5")
    require(counts["gram_ad_bwd"] == differentiated[0] > 0,
            f"one K5 backward per differentiated gram ({counts['gram_ad_bwd']} launches, "
            f"{differentiated[0]} grams)")
    require(rel_lml <= GATE_LML and rel_params <= GATE_PARAMS,
            "fp32 training within the gates of the float64 run")
    return torch.tensor(x, dtype=torch.float32), torch.tensor(y, dtype=torch.float32), fit


def phase_train_exact_profile(device, x32, y32, fit: dict) -> None:
    """Where the device time of 5 fp32 steps of ``train_exact`` goes
    (torch.profiler). It runs last: a profiler session can miss the
    kernels that the port's library launches, and the ones before it
    (K3's and K6's breakdowns) read them."""
    emit("train_exact_profile", steps=5, **_device_breakdown(
        lambda: GPRegressor(ops.RBF(), noise_variance=5e-4, device=device).fit(
            x32, y32, **{**fit, "max_iters": 5}), top=8))


def phase_train_large(device, gen: np.random.Generator) -> None:
    kernel = ops.RBF()
    x, y, _ = _cg_problem(device, gen, N_BIG)
    p0 = convert.params_from_numpy({"sigma": 1.3, "lengthscale": 1.7}, device=device,
                                   dtype=torch.float32)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = opt.tune_large_scale(kernel, p0, x, y, noise_variance=1e-2, steps=TRAIN_STEPS,
                               num_probes=TRAIN_PROBES, precond_rank=TRAIN_RANK,
                               cg_tol=1e-4, cg_max_iters=200)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kops.launch_counts)
    add_launches(counts)
    trace = [float(t) for t in res.lml_trace]
    params = {k: float(v) for k, v in res.params.items()}
    emit("train_large", n=N_BIG, d=D, steps=TRAIN_STEPS, num_probes=TRAIN_PROBES,
         rank=TRAIN_RANK, cg_tol=1e-4, seconds=seconds, seconds_per_step=seconds / TRAIN_STEPS,
         cg_iters=list(res.cg_iters), surrogate_trace=trace, params=params,
         launches=counts)
    require(all(np.isfinite(trace)), "finite surrogate trace")
    require(abs(params["sigma"] - 1.3) > 1e-4 and abs(params["lengthscale"] - 1.7) > 1e-4,
            "training moved the params")
    require(counts["gram_matvec_sym"] > 0, "K3 launched in training")
    require(counts["gram_matvec_bwd_sym"] == TRAIN_STEPS and counts["gram_matvec_bwd"] == 0,
            "one symmetric K4 sweep per step, no full one")

    # at n = 4096 with the kernels on, read as a path of its own: the
    # estimator against the exact LML, on the JAX suite's problem
    # (tests/test_large_scale.py: d = 3, noise 0.05)
    x64 = torch.tensor(gen.uniform(-5, 5, (N_PARITY, 3)), device=device)
    y64 = torch.sin(0.9 * x64.sum(dim=1)) + 0.05 * torch.tensor(
        gen.standard_normal(N_PARITY), device=device)
    xs, ys = x64.float(), y64.float()
    p64 = convert.params_from_numpy({"sigma": 1.3, "lengthscale": 1.7}, device=device,
                                    dtype=torch.float64)
    for leaf in p64.values():
        leaf.requires_grad_(True)
    exact = gp.log_marginal_likelihood(kernel, p64, x64, y64, noise_variance=1e-2)
    g_exact = torch.autograd.grad(exact, list(p64.values()))
    p32 = {k: v.detach().float().requires_grad_(True) for k, v in p64.items()}
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    est = opt.lml_surrogate(kernel, p32, xs, ys, torch.Generator(device=device).manual_seed(1),
                            noise_variance=1e-2, num_probes=64, cg_tol=1e-5,
                            cg_max_iters=1000, precond_rank=512)
    g_est = torch.autograd.grad(est, list(p32.values()))
    torch.cuda.synchronize()
    require(kops.launch_counts["gram_matvec_bwd"] == 1
            and kops.launch_counts["gram_matvec_bwd_sym"] == 0,
            "the 64-probe estimator (65 columns) ran one full K4 sweep")
    grad_rel = {k: abs(float(a) - float(b)) / abs(float(b))
                for k, a, b in zip(p64, g_est, g_exact)}
    lml0 = float(exact.detach())
    small = opt.tune_large_scale(kernel, {k: v.detach().float() for k, v in p64.items()},
                                 xs, ys, noise_variance=1e-2, steps=10, num_probes=8,
                                 cg_tol=1e-5, cg_max_iters=1000, precond_rank=512,
                                 learning_rate=0.1)
    torch.cuda.synchronize()
    counts = dict(kops.launch_counts)
    add_launches(counts)
    require(counts["gram_matvec_bwd_sym"] == 10, "one symmetric K4 sweep per step at n = 4096")
    lml1 = float(gp.log_marginal_likelihood(
        kernel, {k: v.double() for k, v in small.params.items()}, x64, y64,
        noise_variance=1e-2))
    emit("train_large_parity", n=N_PARITY, grad_rel_err=grad_rel, gate_grad=0.1,
         grad_estimate=[float(g) for g in g_est], grad_exact=[float(g) for g in g_exact],
         lml_before=lml0, lml_after_10_steps=lml1, gate_rise=1.0,
         cg_iters=list(small.cg_iters), launches=counts)
    require(max(grad_rel.values()) < 0.1, "surrogate gradient within 0.1 of the exact one")
    require(lml1 > lml0 + 1.0, "10 matrix-free steps raised the exact LML by more than 1")


def _cls_data(gen: np.random.Generator, n: int, m: int):
    """The JAX laplace benches' data: x uniform in [-3, 3]^2, binary labels
    sign(sin(1.5 x0) - x1), three angle classes, m test points."""
    x = gen.uniform(-3.0, 3.0, (n, 2))
    y = np.where(np.sin(1.5 * x[:, 0]) - x[:, 1] > 0.0, 1.0, -1.0)
    y3 = ((np.arctan2(x[:, 1], x[:, 0]) + np.pi) / (2 * np.pi) * C_CLS).astype(int) % C_CLS
    return x, y, y3, gen.uniform(-3.0, 3.0, (m, 2))


def _agreement(prob: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |d prob|, label agreement) of a binary (m,) or multi-class
    (C, m) probability against a reference."""
    err = float(torch.max(torch.abs(prob.double() - ref.double())))
    if prob.ndim == 1:
        same = (prob >= 0.5) == (ref >= 0.5)
    else:
        same = torch.argmax(prob, dim=0) == torch.argmax(ref, dim=0)
    return err, float(torch.mean(same.double()))


def _gate(name: str, err: float, agree: float) -> None:
    require(err <= GATE_PROB and agree >= GATE_LABELS,
            f"{name}: max |d prob| {err:.3e} <= {GATE_PROB} and labels {agree:.4f} "
            f">= {GATE_LABELS}")


def phase_classify_dense(device, gen: np.random.Generator) -> None:
    x, y, y3, xt = _cls_data(gen, N_CLS, M_CLS)

    def run(kind, dtype, n=N_CLS):
        model = (GPBinaryClassifier(ops.RBF(), device=device) if kind == "binary"
                 else GPMulticlassClassifier(ops.RBF(), C_CLS, device=device))
        labels = torch.tensor((y if kind == "binary" else y3)[:n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(torch.tensor(x[:n], dtype=dtype), labels, solver="cholesky")
        prob = model.predict_proba(torch.tensor(xt, dtype=dtype))
        torch.cuda.synchronize()
        return model, prob, time.perf_counter() - t0

    for kind in ("binary", "multiclass"):
        for dtype in (torch.float32, torch.float64):  # warm-up: solver handles
            run(kind, dtype, n=512)
        kops.reset_launch_counts()
        model, prob, seconds = run(kind, torch.float32)
        counts = dict(kops.launch_counts)
        add_launches(counts)
        ref, ref_prob, ref_seconds = run(kind, torch.float64)
        err, agree = _agreement(prob, ref_prob)
        emit("classify_dense", model=kind, n=N_CLS, m=M_CLS, d=2, kernel="RBF(1, 1)",
             dtype="float32", seconds=seconds, seconds_float64=ref_seconds,
             newton_iters=model.state.iters, newton_iters_float64=ref.state.iters,
             converged=model.state.converged, max_abs_prob_err=err, label_agreement=agree,
             gates={"prob": GATE_PROB, "labels": GATE_LABELS}, launches=counts)
        require(bool(torch.isfinite(prob).all()) and model.state.converged,
                f"{kind}: finite probabilities from a converged fit")
        _gate(f"dense {kind} fp32 vs float64", err, agree)
        require(counts["gram"] > 0 and counts["gram_ad"] > 0, f"dense {kind} launched K1")


def _timed(fn):
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(kops.launch_counts)
    add_launches(counts)
    return out, time.perf_counter() - t0, counts


def _large_pipeline(kind, params, x, y, xt, *, rank):
    """The matrix-free fit and prediction: ((state, fit s, fit launches),
    (prediction, predict s, predict launches))."""
    kernel = ops.RBF()
    if kind == "binary":
        fit = _timed(lambda: gp.laplace_fit_cg(kernel, params, x, y, cg_tol=CLS_CG_TOL,
                                               precond_rank=rank))
        pred = _timed(lambda: gp.predict_binary_cg(kernel, params, fit[0], x, xt,
                                                   cg_tol=CLS_CG_TOL, test_chunk=BIN_CHUNK))
    else:
        fit = _timed(lambda: gp.laplace_fit_multiclass_cg(kernel, params, x, y, C_CLS,
                                                          cg_tol=CLS_CG_TOL,
                                                          precond_rank=rank))
        pred = _timed(lambda: gp.predict_multiclass_cg(kernel, params, fit[0], x, y, xt, C_CLS,
                                                       test_chunk=MC_CHUNK))
    return fit, pred


def phase_classify_large(device, gen: np.random.Generator) -> None:
    x_np, y_np, y3_np, xt_np = _cls_data(gen, N_BIG, M_CLS)
    x, xt = (torch.tensor(a, dtype=torch.float32, device=device) for a in (x_np, xt_np))
    labels = {"binary": torch.tensor(y_np, dtype=torch.float32, device=device),
              "multiclass": torch.tensor(y3_np, device=device)}
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=device,
                                       dtype=torch.float32)
    for kind, rank in (("binary", BIN_RANK), ("multiclass", MC_RANK)):
        (st, fit_s, fit_counts), (pred, pred_s, pred_counts) = _large_pipeline(
            kind, params, x, labels[kind], xt, rank=rank)
        emit("classify_large", model=kind, n=N_BIG, m=M_CLS, d=2, rank=rank, cg_tol=CLS_CG_TOL,
             test_chunk=BIN_CHUNK if kind == "binary" else MC_CHUNK,
             newton_iters=st.iters, inner_cg_iters=st.inner_iters, converged=st.converged,
             error_trace=[float(e) for e in st.error_trace[:st.iters]],
             fit_seconds=fit_s, predict_seconds=pred_s,
             predict_cg_iters=pred_counts["gram_matvec_full"] if kind == "binary" else None,
             fit_launches=fit_counts, predict_launches=pred_counts)
        require(st.converged, f"the n = {N_BIG} {kind} Newton fit converged")
        require(pred.prob.shape[-1] == M_CLS and bool(torch.isfinite(pred.prob).all()),
                f"{kind}: finite probabilities of the expected shape")
        require(fit_counts["gram_matvec_sym"] > 0, f"{kind} Newton launched K3")
        require(pred_counts["gram"] > 0, f"{kind} prediction launched K1")
        if kind == "binary":
            require(bool(torch.isfinite(pred.var).all()), "finite latent variances")
            require(pred_counts["gram_matvec_full"] > 0, "binary prediction launched K2")

        # the same pipeline at n = 4096 against the dense path
        (st_s, _, _), (pred_s_, _, _) = _large_pipeline(
            kind, params, x[:N_CLS], labels[kind][:N_CLS], xt, rank=min(rank, N_CLS))
        dense = (gp.fit_binary(ops.RBF(), params, x[:N_CLS], labels[kind][:N_CLS])
                 if kind == "binary" else
                 gp.fit_multiclass(ops.RBF(), params, x[:N_CLS], labels[kind][:N_CLS], C_CLS))
        dpred = (gp.predict_binary(ops.RBF(), params, dense, x[:N_CLS], xt) if kind == "binary"
                 else gp.predict_multiclass(ops.RBF(), params, dense, x[:N_CLS],
                                            labels[kind][:N_CLS], xt, C_CLS))
        err, agree = _agreement(pred_s_.prob, dpred.prob)
        emit("classify_large_parity", model=kind, n=N_CLS, m=M_CLS, newton_iters=st_s.iters,
             inner_cg_iters=st_s.inner_iters, newton_iters_dense=dense.iters,
             max_abs_prob_err=err, label_agreement=agree,
             gates={"prob": GATE_PROB, "labels": GATE_LABELS})
        require(st_s.converged, f"the n = {N_CLS} {kind} matrix-free fit converged")
        _gate(f"matrix-free {kind} vs dense at n = {N_CLS}", err, agree)


def phase_estimator_numpy(device, gen: np.random.Generator) -> None:
    """The binary classifier from NumPy float64 at n = 40000: ``fit``
    stores fp32 (torch's default dtype), ``solver="auto"`` goes matrix-free
    and launches K3; its probabilities against the same fit from fp32
    tensors."""
    x, y, _, xt = _cls_data(gen, N_NUMPY, M_CLS)
    model, seconds, counts = _timed(
        lambda: GPBinaryClassifier(ops.RBF(), device=device).fit(x, y, solver="auto"))
    prob = model.predict_proba(xt)
    ref = GPBinaryClassifier(ops.RBF(), device=device).fit(
        torch.tensor(x, dtype=torch.float32), torch.tensor(y, dtype=torch.float32), solver="cg")
    err, agree = _agreement(prob, ref.predict_proba(torch.tensor(xt, dtype=torch.float32)))
    emit("estimator_numpy", model="binary", n=N_NUMPY, m=M_CLS, input="numpy float64",
         stored_dtype=str(model.x_train.dtype), solver=model._solver,
         newton_iters=model.state.iters, converged=model.state.converged, fit_seconds=seconds,
         max_abs_prob_err_vs_fp32_tensors=err, label_agreement=agree, launches=counts)
    require(model.x_train.dtype == torch.float32 and model._solver == "cg",
            "NumPy float64 input stored as fp32 and fitted matrix-free")
    require(counts["gram_matvec_sym"] > 0 and model.state.converged,
            "the NumPy-fed fit launched K3 and converged")
    require(prob.shape == (M_CLS,) and bool(torch.isfinite(prob).all()),
            "finite probabilities of the expected shape")
    _gate("NumPy-fed vs fp32-tensor fit", err, agree)


def _entry_flops(d: int) -> int:
    """fp32 operations of one RBF kernel entry: the squared distance (d
    subtractions and d FMAs) and the leaf (two products and an exp)."""
    return 3 * d + 3


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: flops over the fp32 peak or
    bytes over the HBM rate, whichever is larger, and which one it is."""
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _bound_k2(n: int, m: int, d: int, r: int) -> dict:
    """K2's bound: its 3 x 2 n m r_pad TF32 MMA operations (r_pad,
    r rounded up to the MMA's 8 columns) at the dense TF32 rate, against
    its n m entries on the fp32 pipe (two units that run at once, so the
    larger), against its bytes at the HBM rate; ``ops_unit`` says which
    unit bounds the operations."""
    r_pad = -(-r // 8) * 8
    mma_ms = 3 * 2 * n * m * r_pad / TF32_FLOPS * 1e3
    entry_ms = n * m * _entry_flops(d) / FP32_FLOPS * 1e3
    bytes_ms = (n * d + m * d + m * r + n * r) * 4 / HBM_BYTES * 1e3
    ops_ms = max(mma_ms, entry_ms)
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_unit": "tf32 tensor cores" if mma_ms >= entry_ms else "fp32 pipe",
            "tf32_ms": mma_ms, "entry_ms": entry_ms}


def _chol_data(n: int):
    """bench.py's _make_data: x uniform in [-5, 5]^4, y = sin(0.9 sum x) +
    0.02 noise, from its own seed 0."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-5.0, 5.0, (n, D))
    return x, np.sin(0.9 * x.sum(axis=1)) + 0.02 * rng.standard_normal(n)


def _chol_K(device, x: torch.Tensor) -> torch.Tensor:
    """K of the chol mode, RBF(1, 1) + 5e-4 I in fp32, by the dense-gram
    dispatcher (K1)."""
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=device,
                                       dtype=torch.float32)
    return linalg.add_diagonal(kops.gram(ops.RBF(), params, x), NOISE_CHOL)


def _device_breakdown(fn, top: int = 6) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler,
    after a warm-up): the total and the ``top`` largest items, and the
    call's wall time under the profiler, in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only: operator rows would count their kernels twice
    times = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^(void )?\(anonymous namespace\)::", "", ev.name).split("(")[0][:48]
            times[name] = times.get(name, 0.0) + ev.device_time_total / 1e3
    items = sorted(times.items(), key=lambda kv: -kv[1])
    return {"device_ms": sum(times.values()), "wall_ms": wall_ms,
            "largest": [[k, v] for k, v in items[:top]]}


def _panel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.max(torch.abs(got.double() - want)) / torch.max(torch.abs(want)))


def phase_kernels_chol(device, gen: np.random.Generator) -> dict:
    """K6 against its plain version and both against float64 torch.linalg,
    on the chol mode's first diagonal panel and on X X^T / b + I panels; the
    indefinite panel's NaN; then K6, the plain version and the library pair
    cholesky_ex + solve_triangular(L, I) timed at b = 1024."""
    x = torch.tensor(_chol_data(BLOCK_CHOL)[0], dtype=torch.float32, device=device)
    panels = {"rbf_chol_panel_1024": _chol_K(device, x)}
    for b in CHOL_PANELS:
        X = torch.tensor(gen.standard_normal((b, b)), dtype=torch.float32, device=device)
        panels[f"xxt_{b}"] = X @ X.T / b + torch.eye(b, device=device)
    rows = []
    for name, A in panels.items():
        b = A.shape[0]
        before = kops.launch_counts["chol_inv_panel"]
        L, W = kchol.chol_inv_panel(A)
        torch.cuda.synchronize()
        require(kops.launch_counts["chol_inv_panel"] == before + 1, "chol_inv_panel launched")
        Lp, Wp = kchol.chol_inv_panel_reference(A)
        L64 = torch.linalg.cholesky(A.double())
        W64 = torch.linalg.solve_triangular(
            L64, torch.eye(b, dtype=torch.float64, device=device), upper=False)
        row = {"panel": name, "b": b}
        for part, got, plain, ref in (("L", L, Lp, L64), ("W", W, Wp, W64)):
            err, plain_err = _panel_err(got, ref), _panel_err(plain, ref)
            gate = CHOL_PANEL_RTOL if plain_err <= CHOL_PANEL_RTOL else 2.0 * plain_err
            row.update({f"{part}_rel_err": err, f"{part}_plain_rel_err": plain_err,
                        f"{part}_gate": gate,
                        f"{part}_vs_plain_abs": float(torch.max(torch.abs(got - plain)))})
            require(np.isfinite(err) and err <= gate,
                    f"{name}: K6's {part} within {gate:.3e} of float64 (got {err:.3e})")
            require(bool(torch.all(torch.triu(got, 1) == 0)), f"{name}: {part} is lower")
        rows.append(row)
    # an indefinite pivot: NaN from there on down L's diagonal
    A = panels["xxt_640"].clone()
    A[100, 100] = -1e3
    L, _ = kchol.chol_inv_panel(A)
    d = torch.diagonal(L)
    nan_ok = bool(torch.isfinite(d[:100]).all() and torch.isnan(d[100:]).all())
    emit("kernels_chol_vs_plain",
         tolerance=f"L, W within {CHOL_PANEL_RTOL} x max|float64| where the plain version is, "
                   "else within 2x the plain version's error; zero above the diagonal",
         rows=rows, indefinite_nan_on_diagonal=nan_ok)
    require(nan_ok, "an indefinite panel gives NaN on L's diagonal")

    # timed on the path's panel: plain, kernel, kernel, plain; then the
    # library pair the port never calls on this path
    A = panels["rbf_chol_panel_1024"]
    b = A.shape[0]
    eye = torch.eye(b, device=device)
    row = _in_turns(lambda: kchol.chol_inv_panel(A), lambda: kchol.chol_inv_panel_reference(A),
                    50, 2)
    library = lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(A)[0], eye,
                                                    upper=False)
    breakdown = _device_breakdown(lambda: kchol.chol_inv_panel(A))
    diag_ms = sum(ms for name, ms in breakdown["largest"] if name == "diag_kernel")
    row.update(kernel="chol_inv_panel", b=b, max_abs_err=max(rows[0]["L_vs_plain_abs"],
                                                             rows[0]["W_vs_plain_abs"]),
               library_ms=_time_ms(library, 50),
               **_bound(2 * b ** 3 / 3, 3 * b * b * 4),
               device_breakdown=breakdown,
               # None where the trace caught none of the port's kernels
               diag_kernel_share=(diag_ms / breakdown["device_ms"] if breakdown["device_ms"]
                                  else None))
    emit("kernels_chol_timed", panel="rbf_chol_panel_1024",
         library="torch.linalg.cholesky_ex + solve_triangular(L, I)", **row)
    return row


def _lml(L: torch.Tensor, y: torch.Tensor, blocked: bool) -> torch.Tensor:
    """R&W Alg. 2.1's LML from a factor, with the corrected log-determinant
    sum(log diag L): alpha by blocked_tri_solve with shared panel inverses
    for a blocked factor, by triangular solves otherwise."""
    if blocked:
        invs = linalg.panel_inverses(L, block=BLOCK_CHOL)
        v = linalg.blocked_tri_solve(L, y, block=BLOCK_CHOL, invs=invs)
        alpha = linalg.blocked_tri_solve(L, v, trans=True, block=BLOCK_CHOL, invs=invs)
    else:
        alpha = linalg.cholesky_solve(L, y)
    return (-0.5 * torch.dot(y, alpha) - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * y.shape[0] * np.log(2 * np.pi))


def phase_chol_blocked(device) -> None:
    """The chol mode at full width: K by K1, ``linalg.blocked_cholesky`` with
    K6 panels (exactly one K6 launch per panel), alpha and the LML; beside
    it on the same K the library-panel blocked factor, fp32 cholesky_ex and
    the float64 torch.linalg reference."""
    x_np, y_np = _chol_data(N_CHOL)
    x = torch.tensor(x_np, dtype=torch.float32, device=device)
    y = torch.tensor(y_np, dtype=torch.float32, device=device)
    panels = -(-N_CHOL // BLOCK_CHOL)

    def kernel_factor(K):
        return linalg.blocked_cholesky(K, block=BLOCK_CHOL, use_kernel=True)

    def path():
        K = _chol_K(device, x)
        L = kernel_factor(K)
        return K, L, _lml(L, y, True)

    path()  # warm-up: cuBLAS handles, the build
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    K, L, lml = path()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kops.launch_counts)
    add_launches(counts)
    require(counts["chol_inv_panel"] == panels,
            f"{panels} K6 launches on the path (got {counts['chol_inv_panel']})")
    require(counts["gram"] > 0, "K came from K1")

    K64 = K.double()
    y64 = y.double()
    variants = {
        "kernel_panels": (kernel_factor, True, y),
        "library_panels": (lambda K: linalg.blocked_cholesky(K, block=BLOCK_CHOL), True, y),
        "cholesky_ex_fp32": (lambda K: torch.linalg.cholesky_ex(K)[0], False, y),
        "float64": (lambda K: torch.linalg.cholesky(K.double()), False, y64),
    }
    rows = {}
    for name, (factor, blocked, rhs) in variants.items():
        Lv = L if name == "kernel_panels" else factor(K)
        lml_v = lml if name == "kernel_panels" else _lml(Lv, rhs, blocked)
        rows[name] = {
            "factor_ms": _time_ms(lambda: factor(K), 3),
            "ms": _time_ms(lambda: _lml(factor(K), rhs, blocked), 3),
            "finite": bool(torch.isfinite(Lv).all()),
            "lml": float(lml_v),
        }
        L64 = Lv.double()
        rows[name]["backward_err"] = float(torch.max(torch.abs(L64 @ L64.T - K64))
                                           / torch.max(torch.abs(K64)))
        del L64
    ref = rows["float64"]["lml"]
    for row in rows.values():
        row["rel_lml"] = abs(row["lml"] - ref) / abs(ref)
    gate = 2 * rows["library_panels"]["backward_err"] + 1e-7
    rows["kernel_panels"]["device_breakdown"] = _device_breakdown(lambda: kernel_factor(K))
    rows["library_panels"]["device_breakdown"] = _device_breakdown(
        lambda: linalg.blocked_cholesky(K, block=BLOCK_CHOL))
    emit("chol_blocked", n=N_CHOL, d=D, block=BLOCK_CHOL, kernel="RBF(1, 1)", noise=NOISE_CHOL,
         dtype="float32", path_seconds=seconds, launches=counts, variants=rows,
         gate_backward_err=gate, note="rel LML reported, not gated")
    require(rows["kernel_panels"]["finite"], "the K6-panel factor is finite")
    require(rows["kernel_panels"]["backward_err"] <= gate,
            f"K6-panel backward error {rows['kernel_panels']['backward_err']:.3e} <= {gate:.3e}")


# ------------------------------------------------ segmented solvers and CO2


class _Stop(Exception):
    """Raised from a callback to stop a run part way, as a preemption."""


def _zeroed(tree):
    """A template shaped like ``tree`` holding zeros: what a fresh process
    has before it restores a checkpoint."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeroed(c) for c in tree))
    if isinstance(tree, tuple):
        return tuple(_zeroed(c) for c in tree)
    return tree


def phase_segmented(device, gen: np.random.Generator, tmp: Path) -> None:
    """``gp.posterior_cg_segmented`` at phase 5's inputs and m = 64 in
    chunks of 8, ``segment_iters`` 2: every chunk converged, K3 and K1
    launched; a run stopped after the second segment of chunk 3, its
    snapshot saved by ``utils.checkpoint`` and restored into a zeroed
    template, resumed in a new call with the uninterrupted run's total
    iterations and bits; at n = 4096 the same pipeline against the exact
    path."""
    kernel = ops.RBF()
    x, y, params = _cg_problem(device, gen, N_BIG)
    xs = x[:SEG_M] + 0.1
    kw = dict(noise_variance=1e-2, tol=SEG_TOL, max_iters=120, segment_iters=SEG_ITERS,
              test_chunk=SEG_CHUNK, precond_rank=SEG_RANK)
    finals = {}
    post, seconds, counts = _timed(lambda: gp.posterior_cg_segmented(
        kernel, params, x, y, xs, checkpoint_cb=finals.__setitem__, **kw))
    require(post.mean.shape == (SEG_M,) and bool(torch.isfinite(post.mean).all())
            and bool(torch.isfinite(post.var).all()), "finite segmented outputs")
    chunks = []
    for c, state in sorted(finals.items()):
        Ks = kops.gram(kernel, params, x, xs[c * SEG_CHUNK:(c + 1) * SEG_CHUNK])
        rhs = (torch.cat([y[:, None], Ks], dim=1) if c == 0 else Ks).double()
        stop = SEG_TOL * float(torch.sqrt(torch.max(torch.sum(rhs * rhs, dim=0))))
        chunks.append({"chunk": c, "iters": state.iters, "resnorm": float(state.resnorm),
                       "stop": stop})
    emit("segmented", n=N_BIG, m=SEG_M, d=D, rank=SEG_RANK, tol=SEG_TOL, test_chunk=SEG_CHUNK,
         segment_iters=SEG_ITERS, iters=post.iters, seconds=seconds, chunks=chunks,
         launches=counts)
    require(len(chunks) == SEG_M // SEG_CHUNK, "every chunk solved")
    for row in chunks:
        require(row["resnorm"] <= row["stop"], f"chunk {row['chunk']} converged")
    require(counts["gram_matvec_sym"] > 0 and counts["gram"] > 0,
            "the segmented solve launched K3 and K1")

    # stopped after the second segment of chunk 3, resumed from disk
    path = str(tmp / "segmented")
    seen = []

    def stop_cb(snap):
        if snap.chunk == SEG_STOP_CHUNK:
            seen.append(snap)
            if len(seen) == 2:
                checkpoint.save(path, snap)
                raise _Stop

    t0 = time.perf_counter()
    try:
        gp.posterior_cg_segmented(kernel, params, x, y, xs, snapshot_cb=stop_cb, **kw)
    except _Stop:
        pass
    stopped_seconds = time.perf_counter() - t0
    require(len(seen) == 2 and seen[-1].state.iters < finals[SEG_STOP_CHUNK].iters,
            f"the run stopped mid-solve, after the second segment of chunk {SEG_STOP_CHUNK}")
    restored = checkpoint.restore(path, _zeroed(seen[-1]))
    resumed, resume_seconds, _ = _timed(lambda: gp.posterior_cg_segmented(
        kernel, params, x, y, xs, resume=restored, **kw))
    same = {"iters": [post.iters, resumed.iters],
            "mean_bitwise_equal": bool(torch.equal(post.mean, resumed.mean)),
            "var_bitwise_equal": bool(torch.equal(post.var, resumed.var))}
    emit("segmented_resume", stopped_at={"chunk": SEG_STOP_CHUNK,
                                         "iters": restored.state.iters},
         stopped_seconds=stopped_seconds, resume_seconds=resume_seconds, **same)
    require(post.iters == resumed.iters and same["mean_bitwise_equal"]
            and same["var_bitwise_equal"], "the resumed run: equal iterations and bits")

    # the same pipeline at n = 4096 against the exact path (phase 5's gate)
    xp, yp, xsp = x[:N_PARITY], y[:N_PARITY], x[:8] + 0.1
    dense = gp.posterior(kernel, params, xp, yp, xsp, noise_variance=1e-2)
    small = gp.posterior_cg_segmented(kernel, params, xp, yp, xsp, noise_variance=1e-2,
                                      tol=1e-8, segment_iters=SEG_ITERS, test_chunk=8,
                                      precond_rank=512)
    mean_err = float(torch.max(torch.abs(small.mean - dense.mean)))
    var_err = float(torch.max(torch.abs(small.var - dense.var)))
    emit("segmented_parity", n=N_PARITY, m=8, mean_abs_err=mean_err, var_abs_err=var_err,
         gate=1e-2)
    require(mean_err < 1e-2 and var_err < 1e-2, "segmented vs Cholesky parity at n=4096")


def phase_segmented_laplace(device, gen: np.random.Generator, tmp: Path) -> None:
    """``gp.laplace_fit_cg_segmented`` at phase 10's binary inputs, one
    Newton step a call: it converges through K3; a run stopped after 3
    steps, its iterate saved and restored, continued by ``resume_f`` to the
    uninterrupted mode with equal bits and Newton count; its prediction
    against ``laplace_fit_cg``'s."""
    x_np, y_np, _, xt_np = _cls_data(gen, N_BIG, M_CLS)
    x, y, xt = (torch.tensor(a, dtype=torch.float32, device=device) for a in (x_np, y_np, xt_np))
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=device,
                                       dtype=torch.float32)
    kernel = ops.RBF()
    kw = dict(precond_rank=BIN_RANK, cg_tol=CLS_CG_TOL, newton_per_call=1)
    st, seconds, counts = _timed(lambda: gp.laplace_fit_cg_segmented(kernel, params, x, y,
                                                                     **kw))
    emit("segmented_laplace", n=N_BIG, d=2, rank=BIN_RANK, cg_tol=CLS_CG_TOL,
         newton_per_call=1, newton_iters=st.iters, inner_cg_iters=st.inner_iters,
         converged=st.converged, error_trace=[float(e) for e in st.error_trace[:st.iters]],
         seconds=seconds, launches=counts)
    require(st.converged, "the segmented Newton fit converged")
    require(counts["gram_matvec_sym"] > 0, "the segmented Newton fit launched K3")

    path = str(tmp / "newton")

    def stop_cb(steps, f):
        if steps == LAPLACE_STOP:
            checkpoint.save(path, {"steps": steps, "f": f})
            raise _Stop

    try:
        gp.laplace_fit_cg_segmented(kernel, params, x, y, checkpoint_cb=stop_cb, **kw)
    except _Stop:
        pass
    saved = checkpoint.restore(path, {"steps": 0, "f": torch.zeros_like(st.f_mode)})
    resumed, resume_seconds, _ = _timed(lambda: gp.laplace_fit_cg_segmented(
        kernel, params, x, y, resume_f=saved["f"], **kw))
    equal = bool(torch.equal(resumed.f_mode, st.f_mode))
    pred = gp.predict_binary_cg(kernel, params, st, x, xt, cg_tol=CLS_CG_TOL,
                                test_chunk=BIN_CHUNK)
    mono = gp.laplace_fit_cg(kernel, params, x, y, cg_tol=CLS_CG_TOL, precond_rank=BIN_RANK)
    ref = gp.predict_binary_cg(kernel, params, mono, x, xt, cg_tol=CLS_CG_TOL,
                               test_chunk=BIN_CHUNK)
    err, agree = _agreement(pred.prob, ref.prob)
    emit("segmented_laplace_resume", stopped_after=saved["steps"],
         newton_iters=[st.iters, saved["steps"] + resumed.iters], f_bitwise_equal=equal,
         resume_seconds=resume_seconds, monolithic_newton_iters=mono.iters,
         max_abs_prob_err_vs_monolithic=err, label_agreement=agree, gate_prob=GATE_PROB)
    require(equal and saved["steps"] + resumed.iters == st.iters,
            "the resumed Newton fit: equal bits and Newton count")
    require(bool(torch.isfinite(pred.prob).all()) and err <= GATE_PROB,
            "segmented fit's prediction within 5e-3 of the monolithic fit's")


def _co2_k1_timed(wk, wp, xc: torch.Tensor) -> dict:
    """K1 at the whitened CO2 shape (526^2, d = 1, the interpreter): its
    launch alone queued behind a device sleep (the card's time), the
    dispatcher ``kops.gram`` a call (program, coefficients and launch, as
    the batched LML calls it: paced by the host) and the plain version,
    CUDA events, with the bound (bytes: the output)."""
    n = xc.shape[0]
    launch = _gram_launch(wk, wp, xc, None)
    plain = lambda: kops.gram_reference(wk, wp, xc)  # noqa: E731
    row = _in_turns(launch, plain, 50, 20, timer=_queued_ms)
    err, _ = _gram_err(launch(), plain())
    instructions = len(kops.gram_program(wk, wp, True)[0])
    # operations: at least an RBF entry's per instruction, below the bytes
    return {"n": n, "d": 1, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "dispatcher_ms": _time_ms(lambda: kops.gram(wk, wp, xc), 50),
            "max_abs_err": err, "instructions": instructions,
            **_bound(n * n * instructions * _entry_flops(1), 4.0 * n * n)}


def phase_co2(device, gen: np.random.Generator, tmp: Path) -> None:
    """The Mauna Loa CO2 pipeline on the vendored record (526 points): (a)
    the whitened fp32 20-year band against float64 on the card; (b) the
    batched whitened LML over 500 candidates in fp32 (one K1 each) and
    float64; (c) BO with the float64 whitened LML as the objective, four
    acquisitions x 10 iterations x 500 candidates; (d) the two examples as
    subprocesses."""
    x_np, y_np, _ = datasets.mauna_loa()
    xt_np = datasets.mauna_loa_test_grid(x_np, years=20)
    kernel = ops.co2_kernel()
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    book = ops.co2_params_from_vector(f64(THETA_BOOK))

    # (a) the band
    ref = gp.posterior(kernel, book, f64(x_np), f64(y_np), f64(xt_np), noise_variance=CO2_NOISE)
    w, seconds, counts = _timed(lambda: gp.whitened_posterior(
        kernel, book, x_np, y_np, xt_np, noise_variance=CO2_NOISE, dtype=torch.float32,
        device=device))
    dmean = float(torch.max(torch.abs(w.mean.double() - ref.mean)))
    dstd = float(torch.max(torch.abs(w.std.double() - ref.std)))
    wk, wp = gp.whitened.whitened_kernel(kernel, book, w.y_scale, dtype=torch.float32,
                                         device=device)
    xc = torch.as_tensor(x_np - w.x_shift, dtype=torch.float32, device=device)
    emit("co2_band", n=x_np.shape[0], m=xt_np.shape[0], dtype="float32", seconds=seconds,
         max_abs_mean_err_ppm=dmean, max_abs_std_err_ppm=dstd, jitter=float(w.jitter),
         lml=w.lml, lml_float64=float(ref.lml), gates={"mean_ppm": 1.0, "std_ppm": 0.1},
         launches=counts, k1_timed=_co2_k1_timed(wk, wp, xc))
    require(dmean <= 1.0 and dstd <= 0.1, "whitened fp32 band within 1.0 / 0.1 ppm")
    require(counts["gram"] >= 2, "the whitened band launched K1 for K and K_s")

    # (b) the batched LML, fp32 prescreen and float64 search surface
    lo, hi = np.maximum(THETA_BOOK * 0.5, 1e-3), THETA_BOOK * 1.5
    cands = gen.uniform(lo, hi, size=(CO2_CANDIDATES, THETA_BOOK.size))
    batch = {dt: gp.make_whitened_lml_fn(kernel, ops.co2_params_from_vector, x_np, y_np,
                                         noise_variance=CO2_NOISE, dtype=dt, device=device)
             for dt in (torch.float32, torch.float64)}
    lml32, s32, c32 = _timed(lambda: batch[torch.float32](cands))
    lml64, s64, c64 = _timed(lambda: batch[torch.float64](cands))
    serial = [gp.whitened_lml(kernel, ops.co2_params_from_vector(f64(th)), x_np, y_np,
                              noise_variance=CO2_NOISE, dtype=torch.float64, device=device)
              for th in cands[:CO2_SERIAL]]
    lml_book = float(gp.log_marginal_likelihood(kernel, book, f64(x_np), f64(y_np),
                                                noise_variance=CO2_NOISE))
    book_batch = float(batch[torch.float64](THETA_BOOK)[0])
    serial_err = float(np.max(np.abs(lml64[:CO2_SERIAL] - serial) / np.abs(serial)))
    best32 = int(np.argmax(lml32))
    # one chunk of the fp32 batch under the profiler: the card's busy share
    breakdown = _device_breakdown(lambda: batch[torch.float32](cands[:128]))
    breakdown["idle_share"] = 1.0 - breakdown["device_ms"] / breakdown["wall_ms"]
    emit("co2_batch_lml", candidates=CO2_CANDIDATES, fp32_seconds=s32, float64_seconds=s64,
         fp32_ms_per_candidate=s32 / CO2_CANDIDATES * 1e3,
         float64_ms_per_candidate=s64 / CO2_CANDIDATES * 1e3,
         fp32_max_abs_dlml=float(np.max(np.abs(lml32 - lml64))),
         fp32_median_abs_dlml=float(np.median(np.abs(lml32 - lml64))),
         fp32_best_float64_rank=int(np.sum(lml64 > lml64[best32])) + 1,
         best_float64=float(np.max(lml64)), serial_max_rel_err=serial_err,
         book_abs_err_vs_direct=abs(book_batch - lml_book), lml_book=lml_book,
         fp32_launches=c32, float64_launches=c64, fp32_chunk_breakdown=breakdown)
    require(bool(np.isfinite(lml32).all() and np.isfinite(lml64).all()), "finite batched LMLs")
    require(c32["gram"] == CO2_CANDIDATES, f"exactly {CO2_CANDIDATES} K1 launches in fp32")
    require(serial_err <= 1e-10, "float64 batch within rtol 1e-10 of the serial LML")
    require(abs(book_batch - lml_book) <= 1e-8 * abs(lml_book),
            "float64 batch within 1e-8 of the direct LML")

    # (c) BO on the float64 whitened LML
    objective = lambda th: float(batch[torch.float64](th)[0])  # noqa: E731
    rows = {}
    for acq in ("PI", "EI", "UCB", "TS"):
        t0 = time.perf_counter()
        bo = opt.tune_bayesian_opt(objective, initial_points=THETA_BOOK[None, :] + 0.5,
                                   bounds=(lo, hi), n_iterations=10,
                                   n_candidates=CO2_CANDIDATES, acquisition=acq, seed=0)
        rows[acq] = {"best_lml": bo.best_value, "evaluations": len(bo.values),
                     "stopped_early": bo.stopped_early,
                     "seconds": time.perf_counter() - t0,
                     "within_5pct_of_book": bo.best_value > lml_book - 0.05 * abs(lml_book)}
    emit("co2_bo", lml_book=lml_book, iterations=10, candidates=CO2_CANDIDATES, seed=0,
         acquisitions=rows)
    require(rows["PI"]["stopped_early"] and rows["PI"]["evaluations"] == 2
            and np.isfinite(rows["PI"]["best_lml"]), "PI stopped after its first proposal")
    for acq in ("EI", "UCB", "TS"):
        require(rows[acq]["within_5pct_of_book"], f"BO {acq} within 5% of the book LML")
    require(max(r["best_lml"] for r in rows.values()) > lml_book, "BO beats the book LML")

    # (d) the examples, as a user runs them
    examples = {}
    root = Path(__file__).resolve().parent
    for name, args, event in (("co2", ["--skip-bo"], "book_lml"),
                              ("tune_hyperparms_regression", [], "gradient_ascent_done")):
        out = tmp / name
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "examples_torch" / f"{name}.py"),
                               *args, "--out", str(out)], capture_output=True, text=True,
                              timeout=600, cwd=root)
        records = ([r for r in read_jsonl(str(out / "run.jsonl")) if r["event"] == event]
                   if proc.returncode == 0 else [])
        examples[name] = {"returncode": proc.returncode, "seconds": time.perf_counter() - t0,
                          "lml": records[0]["lml"] if records else None,
                          "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}
    emit("co2_examples", examples=examples)
    for name, row in examples.items():
        require(row["returncode"] == 0 and row["lml"] is not None
                and bool(np.isfinite(row["lml"])), f"examples_torch/{name}.py ran")


def _quiet_timed(fn):
    """``fn()`` and its wall seconds, its launches left out of the paths'
    counts (a comparison run)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_distributed(device, gen: np.random.Generator, tmp: Path) -> None:
    """The data-parallel regression tier (``parallel``) at one rank: a
    one-rank NCCL group on an in-process store, destroyed at the end. (a)
    ``make_posterior_cg`` on phase 5's problem at m = 64 (r = 65: every
    ring step is K2, K1 builds K_s, K3 never runs) against
    ``gp.posterior_cg``; (b) ``distributed_posterior_cg_segmented`` on it,
    6 iterations a segment, resumed from the checkpoints of segments 1 and
    2, and its jacobi variant at n = 4096 against the monolithic solve;
    (c) ``make_distributed_posterior`` at n = 8192, m = 2048 in fp32
    against float64 under phase 4's gates, with K1; (d)
    ``make_distributed_train_step``, 5 steps at n = 8192, fp32 against
    float64, one K5 backward a step; (e) the four new examples as
    subprocesses, ``distributed_regression`` with 4 restarts."""
    import torch.distributed as dist

    from gaussian_process_tpu_torch import parallel

    require(not dist.is_initialized(), "no process group before the distributed phase")
    mesh = parallel.make_mesh(device=device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    require(dist.get_backend() == backend and dist.get_world_size() == 1,
            f"a one-rank {backend} group")
    kernel = ops.RBF()
    try:
        # (a) the matrix-free posterior
        x, y, params = _cg_problem(device, gen, N_BIG)
        xs = x[:DIST_M] + 0.1
        kw = dict(noise_variance=1e-2, tol=DIST_TOL, max_iters=120)
        solver = parallel.make_posterior_cg(kernel, mesh=mesh, preconditioner="nystrom",
                                            precond_rank=DIST_RANK, **kw)
        (mean, var, _, iters, res), seconds, counts = _timed(
            lambda: solver(params, x, y, xs))
        single, single_seconds = _quiet_timed(lambda: gp.posterior_cg(
            kernel, params, x, y, xs, preconditioner="nystrom", precond_rank=DIST_RANK, **kw))
        rhs = torch.cat([y[:, None], ops.gram(kernel, params, x, xs)], dim=1).double()
        stop = DIST_TOL * float(torch.sqrt(torch.max(torch.sum(rhs * rhs, dim=0))))
        dmean = float(torch.max(torch.abs(mean - single.mean)))
        dvar = float(torch.max(torch.abs(var - single.var)))
        emit("distributed_cg", n=N_BIG, m=DIST_M, d=D, rank=DIST_RANK, tol=DIST_TOL, ranks=1,
             iters=iters, iters_posterior_cg=single.iters, resnorm=float(res), stop=stop,
             seconds=seconds, seconds_posterior_cg=single_seconds, max_abs_dmean=dmean,
             max_abs_dvar=dvar, gate=1e-2, launches=counts)
        require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                "finite distributed CG outputs")
        require(float(res) <= stop, "the distributed CG converged")
        require(dmean <= 1e-2 and dvar <= 1e-2, "distributed CG within 1e-2 of posterior_cg")
        require(counts["gram_matvec_full"] > 0 and counts["gram"] > 0
                and counts["gram_matvec_sym"] == 0,
                "the ring launched K2 and K1, and K3 not at all")

        # (b) segmented, checkpointed, resumed
        seg_kw = dict(mesh=mesh, preconditioner="nystrom", precond_rank=DIST_RANK,
                      segment_iters=DIST_SEG_ITERS, **kw)
        states = {}

        def save(i, state):
            states[i] = state.iters
            if i in DIST_RESUME_FROM:
                checkpoint.save(str(tmp / f"dist_seg{i}"), state, per_host=True)

        seg, seg_seconds, seg_counts = _timed(lambda: parallel.distributed_posterior_cg_segmented(
            kernel, params, x, y, xs, checkpoint_cb=save, **seg_kw))
        resumes = {}
        for i in DIST_RESUME_FROM:
            require(i in states, f"the segmented run reached segment {i}")
            restored = checkpoint.restore(str(tmp / f"dist_seg{i}"), _zeroed(seg[5]))
            out, rs_seconds = _quiet_timed(lambda: parallel.distributed_posterior_cg_segmented(
                kernel, params, x, y, xs, resume_state=restored, **seg_kw))
            resumes[i] = {"from_iters": restored.iters, "iters": out[3], "seconds": rs_seconds,
                          "mean_bitwise_equal": bool(torch.equal(out[0], seg[0])),
                          "var_bitwise_equal": bool(torch.equal(out[1], seg[1]))}
        jac_kw = dict(noise_variance=1e-2, tol=DIST_TOL, max_iters=1000,
                      preconditioner="jacobi")
        xj, yj, xsj = x[:N_PARITY], y[:N_PARITY], x[:8] + 0.1
        (jm, jv, _, jit, _), _ = _quiet_timed(lambda: parallel.distributed_posterior_cg(
            kernel, params, xj, yj, xsj, mesh=mesh, **jac_kw))
        jseg, _ = _quiet_timed(lambda: parallel.distributed_posterior_cg_segmented(
            kernel, params, xj, yj, xsj, mesh=mesh, segment_iters=DIST_SEG_ITERS, **jac_kw))
        jacobi = {"n": N_PARITY, "iters": [jit, jseg[3]],
                  "mean_bitwise_equal": bool(torch.equal(jm, jseg[0])),
                  "var_bitwise_equal": bool(torch.equal(jv, jseg[1]))}
        emit("distributed_segmented", segment_iters=DIST_SEG_ITERS, iters=seg[3],
             segments=states, seconds=seg_seconds, max_abs_dmean_vs_monolithic=float(
                 torch.max(torch.abs(seg[0] - mean))), resumes=resumes, jacobi=jacobi,
             launches=seg_counts)
        for i, row in resumes.items():
            require(row["iters"] == seg[3] and row["mean_bitwise_equal"]
                    and row["var_bitwise_equal"],
                    f"the resume from segment {i}: equal iterations and bits")
        require(jacobi["iters"][0] == jacobi["iters"][1] and jacobi["mean_bitwise_equal"]
                and jacobi["var_bitwise_equal"], "jacobi segments equal the monolithic solve")

        # (c) the exact posterior, fp32 against float64 on the card
        n, m = N_EXACT, M_EXACT
        xe = gen.uniform(-5.0, 5.0, (n, D))
        ye = np.sin(0.9 * xe.sum(axis=1)) + 0.02 * gen.standard_normal(n)
        xse = gen.uniform(-5.0, 5.0, (m, D))
        on = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
        p32 = convert.params_from_numpy(kernel.init_params(), device=device,
                                        dtype=torch.float32)
        exact = parallel.make_distributed_posterior(kernel, mesh=mesh, noise_variance=5e-4)
        _quiet_timed(lambda: exact(p32, on(xe, torch.float32), on(ye, torch.float32),
                                   on(xse, torch.float32)))  # warm-up
        (em, ev, el, _), e_seconds, e_counts = _timed(lambda: exact(
            p32, on(xe, torch.float32), on(ye, torch.float32), on(xse, torch.float32)))
        (rm, rv, rl, _), r_seconds = _quiet_timed(lambda: exact(
            convert.params_from_numpy(kernel.init_params(), device=device, dtype=torch.float64),
            on(xe, torch.float64), on(ye, torch.float64), on(xse, torch.float64)))
        rel_mean, rel_var = _rel(em, rm), _rel(ev, rv)
        rel_lml = abs(float(el) - float(rl)) / abs(float(rl))
        emit("distributed_exact", n=n, m=m, d=D, dtype="float32", seconds=e_seconds,
             seconds_float64=r_seconds, rel_mean=rel_mean, rel_lml=rel_lml, rel_var=rel_var,
             gates={"mean": GATE_MEAN, "lml": GATE_LML, "var": GATE_VAR}, launches=e_counts)
        require(rel_mean <= GATE_MEAN and rel_lml <= GATE_LML and rel_var <= GATE_VAR,
                "the distributed exact posterior within the parity gates")
        require(e_counts["gram"] > 0, "the distributed exact posterior launched K1")

        # (d) the training step
        traces, t_seconds, t_counts = {}, {}, None
        for dt in (torch.float32, torch.float64):
            step, init = parallel.make_distributed_train_step(kernel, mesh=mesh)
            batch0 = convert.params_from_numpy({"sigma": np.ones(1), "lengthscale": np.ones(1)},
                                               device=device, dtype=dt)
            state0 = init(batch0)
            xt_, yt_ = on(xe, dt), on(ye, dt)

            def run():
                batch, opt_state, lmls = batch0, state0, []
                for _ in range(DIST_TRAIN_STEPS):
                    res_ = step(batch, opt_state, xt_, yt_)
                    batch, opt_state = res_.params, res_.opt_state
                    lmls.append(float(res_.lml[0]))
                return lmls

            if dt == torch.float32:
                traces[dt], t_seconds[dt], t_counts = _timed(run)
            else:
                traces[dt], t_seconds[dt] = _quiet_timed(run)
        rel_traj = max(abs(a - b) / abs(b) for a, b in zip(traces[torch.float32],
                                                           traces[torch.float64]))
        emit("distributed_train", n=n, d=D, steps=DIST_TRAIN_STEPS, candidates=1,
             seconds=t_seconds[torch.float32], seconds_float64=t_seconds[torch.float64],
             lml=traces[torch.float32], lml_float64=traces[torch.float64],
             rel_lml_max=rel_traj, gate=GATE_LML, launches=t_counts)
        require(rel_traj <= GATE_LML, "fp32 training trajectory within rel 3e-4 of float64")
        require(traces[torch.float32][-1] > traces[torch.float32][0], "the steps raised the LML")
        require(t_counts["gram_ad_bwd"] == DIST_TRAIN_STEPS,
                f"one K5 backward a step ({t_counts['gram_ad_bwd']} in {DIST_TRAIN_STEPS})")
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "the group is gone after the distributed phase")

    # (e) the examples, as a user runs them
    examples = {}
    root = Path(__file__).resolve().parent
    for name, args, event in (("gp_regression", [], "regression_done"),
                              ("gp_binary_classification", [], "classification_done"),
                              ("gp_multi_classification", [], "multiclass_done"),
                              ("distributed_regression", ["--restarts", "4"], "restarts_done")):
        out = tmp / name
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "examples_torch" / f"{name}.py"),
                               *args, "--out", str(out)], capture_output=True, text=True,
                              timeout=600, cwd=root)
        records = ([r for r in read_jsonl(str(out / "run.jsonl")) if r["event"] == event]
                   if proc.returncode == 0 else [])
        examples[name] = {"returncode": proc.returncode, "seconds": time.perf_counter() - t0,
                          "record": records[0] if records else None,
                          "stdout_tail": proc.stdout[-600:],
                          "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}
    emit("distributed_examples", examples=examples)
    for name, row in examples.items():
        require(row["returncode"] == 0 and row["record"] is not None,
                f"examples_torch/{name}.py ran")


def _ring_step_k2(kernel, params, x: torch.Tensor, r: int, gen: np.random.Generator) -> dict:
    """K2 as a ring step calls it, ``x2`` given (here x itself), at r
    columns: against its plain version (the ``KERNEL_RTOL`` gate), both
    timed in turns, and its bound."""
    n, d = x.shape
    v = torch.tensor(gen.standard_normal((n, r)), dtype=torch.float32, device=x.device)
    run = lambda: kops.gram_matvec(kernel, params, x, x, v)  # noqa: E731
    plain = lambda: kops.gram_matvec_reference(kernel, params, x, x, v)  # noqa: E731
    err, scale = _max_err(run(), plain())
    row = _in_turns(run, plain, *((1, 1) if r > 128 else (5, 2)))
    row.update(_bound_k2(n, n, d, r), kernel="gram_matvec_full", n=n, d=d, r=r,
               columns=kops.full_columns(r), max_abs_err=err, max_abs_plain=scale)
    return row


def phase_distributed_classify(device, gen: np.random.Generator) -> None:
    """The distributed classifiers (``parallel``) at one rank, on a one-rank
    NCCL group destroyed at the end: (a) ``distributed_fit_predict_binary``
    at n = 102400 against the single-card matrix-free pair, K2 on every
    ring step, K1 for the cross-grams, K3 never; K2 at the ring's r = 1
    and r = 2048 checked and timed; (b) ``fit_multiclass_sharded`` at
    n = 4096 against ``gp.fit_multiclass`` in fp32 and float64."""
    import torch.distributed as dist

    from gaussian_process_tpu_torch import parallel

    require(not dist.is_initialized(), "no process group before the classifiers' phase")
    mesh = parallel.make_mesh(device=device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    require(dist.get_backend() == backend and dist.get_world_size() == 1,
            f"a one-rank {backend} group")
    kernel = ops.RBF()
    x_np, y_np, y3_np, xt_np = _cls_data(gen, N_BIG, M_CLS)
    x, xt, y = (torch.tensor(a, dtype=torch.float32, device=device) for a in (x_np, xt_np, y_np))
    params = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=device,
                                       dtype=torch.float32)
    try:
        # (a) binary, n = 102400: the path, then the single-card pair
        kw = dict(cg_tol=CLS_CG_TOL, precond_rank=BIN_RANK)
        out, seconds, counts = _timed(lambda: parallel.distributed_fit_predict_binary(
            kernel, params, x, y, xt, mesh=mesh, **kw))
        prob, _, label, _, var, iters, inner, conv = out
        x_p, y_p, n_true = parallel.mesh.pad_inputs(mesh, "data", x, y)
        # the fit and the prediction again, each alone and warm
        fit = parallel.make_distributed_laplace_fit(kernel, mesh=mesh, n_true=n_true, **kw)
        (_, grad, sw, fit_iters, _, _), fit_seconds = _quiet_timed(lambda: fit(params, x_p, y_p))
        predict = parallel.make_distributed_laplace_predict(kernel, mesh=mesh, n_true=n_true,
                                                            **kw)
        _, predict_seconds = _quiet_timed(lambda: predict(params, x_p, grad, sw, xt))
        single, single_fit_s = _quiet_timed(lambda: gp.laplace_fit_cg(kernel, params, x, y,
                                                                      **kw))
        spred, single_pred_s = _quiet_timed(lambda: gp.predict_binary_cg(
            kernel, params, single, x, xt, cg_tol=CLS_CG_TOL, test_chunk=BIN_CHUNK))
        err, agree = _agreement(prob, spred.prob)
        k2 = [_ring_step_k2(kernel, params, x, r, gen) for r in RING_K2_R]
        emit("distributed_binary", n=N_BIG, m=M_CLS, d=2, kernel="RBF(1, 1)", rank=BIN_RANK,
             cg_tol=CLS_CG_TOL, ranks=1, newton_iters=iters, inner_cg_iters=inner,
             converged=conv, newton_iters_single=single.iters,
             inner_cg_iters_single=single.inner_iters, seconds=seconds,
             fit_seconds=fit_seconds, fit_newton_iters=fit_iters, predict_seconds=predict_seconds,
             seconds_single=single_fit_s + single_pred_s, fit_seconds_single=single_fit_s,
             predict_seconds_single=single_pred_s, max_abs_prob_err=err,
             label_agreement=agree, max_abs_dvar=float(torch.max(torch.abs(var - spred.var))),
             gates={"prob": GATE_PROB, "labels": GATE_LABELS}, launches=counts)
        emit("distributed_binary_k2", kernel="RBF(sigma=1, lengthscale=1)", rows=k2)
        require(conv and single.converged, "both binary fits converged")
        require(prob.shape == (M_CLS,) and bool(torch.isfinite(prob).all()
                                                 and torch.isfinite(var).all()),
                "finite distributed probabilities and variances of the expected shape")
        _gate("distributed binary vs the single-card pair", err, agree)
        require(counts["gram_matvec_full"] > 0 and counts["gram"] > 0
                and counts["gram_matvec_sym"] == 0,
                "the distributed Newton and prediction launched K2 and K1, and K3 not at all")

        # (b) class-sharded multi-class, n = 4096
        x4, y3 = x[:N_CLS], torch.tensor(y3_np[:N_CLS], device=device)
        st, mc_seconds, mc_counts = _timed(lambda: parallel.fit_multiclass_sharded(
            kernel, params, x4, y3, C_CLS, mesh=mesh))
        ref32, ref32_s = _quiet_timed(lambda: gp.fit_multiclass(kernel, params, x4, y3, C_CLS))
        p64 = convert.params_from_numpy({"sigma": 1.0, "lengthscale": 1.0}, device=device,
                                        dtype=torch.float64)
        ref64, ref64_s = _quiet_timed(lambda: gp.fit_multiclass(kernel, p64, x4.double(), y3,
                                                                C_CLS))
        pred = gp.predict_multiclass(kernel, params, st, x4, y3, xt, C_CLS)
        pred64 = gp.predict_multiclass(kernel, p64, ref64, x4.double(), y3, xt.double(), C_CLS)
        err, agree = _agreement(pred.prob, pred64.prob)
        emit("distributed_multiclass", n=N_CLS, m=M_CLS, d=2, classes=C_CLS, ranks=1,
             newton_iters=st.iters, newton_iters_single=ref32.iters,
             newton_iters_float64=ref64.iters, converged=st.converged, seconds=mc_seconds,
             seconds_single=ref32_s, seconds_float64=ref64_s,
             max_abs_df_vs_single=float(torch.max(torch.abs(st.f_mode - ref32.f_mode))),
             lml=float(st.lml), lml_single=float(ref32.lml), lml_float64=float(ref64.lml),
             max_abs_prob_err_vs_float64=err, label_agreement=agree,
             gates={"prob": GATE_PROB, "labels": GATE_LABELS}, launches=mc_counts)
        require(st.converged and st.f_mode.shape == (C_CLS, N_CLS)
                and bool(torch.isfinite(pred.prob).all()),
                "the class-sharded fit converged, finite probabilities")
        _gate("class-sharded fp32 vs float64", err, agree)
        require(mc_counts["gram"] == 1, f"K1 launched once ({mc_counts['gram']})")
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "the group is gone after the classifiers' phase")


def phase_multihost(device, gen: np.random.Generator, tmp: Path) -> None:
    """Multi-host bring-up in one process: ``multihost.initialize`` over a
    TCP store on localhost (NCCL on the card), the global mesh, rows
    through ``host_local_to_global`` into the exact distributed posterior,
    barriers, ``live_hosts``, a per-rank checkpoint, and
    ``run_with_redispatch`` around the sharded LML; ``shutdown``."""
    import socket

    import torch.distributed as dist

    from gaussian_process_tpu_torch import parallel
    from gaussian_process_tpu_torch.parallel import multihost

    require(not dist.is_initialized(), "no process group before the multi-host phase")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0,
                         device=None if device.type == "cuda" else "cpu")
    kernel = ops.RBF()
    try:
        backend = "nccl" if device.type == "cuda" else "gloo"
        require(dist.get_backend() == backend and dist.get_world_size() == 1
                and multihost.is_coordinator(), f"a one-process {backend} group, coordinator")
        mesh = multihost.global_mesh(restart=1)
        require(list(mesh.shape) == [1, 1] and mesh.device_type == device.type,
                "a 1 x 1 global mesh on the device")

        n, m = N_EXACT, M_EXACT
        xe = gen.uniform(-5.0, 5.0, (n, D))
        ye = np.sin(0.9 * xe.sum(axis=1)) + 0.02 * gen.standard_normal(n)
        xse = gen.uniform(-5.0, 5.0, (m, D))
        exact = parallel.make_distributed_posterior(kernel, mesh=mesh, noise_variance=5e-4)

        def serve(dt):
            p = convert.params_from_numpy(kernel.init_params(), device=device, dtype=dt)
            xg = multihost.host_local_to_global(mesh, torch.tensor(xe, dtype=dt))
            yg = multihost.host_local_to_global(mesh, torch.tensor(ye, dtype=dt))
            xs = multihost.replicate_to_global(mesh, torch.tensor(xse, dtype=dt))
            return exact(p, xg, yg, xs)

        _quiet_timed(lambda: serve(torch.float32))  # warm-up
        (em, ev, el, alpha), e_seconds, e_counts = _timed(lambda: serve(torch.float32))
        (rm, rv, rl, _), r_seconds = _quiet_timed(lambda: serve(torch.float64))
        rel_mean, rel_var = _rel(em, rm), _rel(ev, rv)
        rel_lml = abs(float(el) - float(rl)) / abs(float(rl))
        require(rel_mean <= GATE_MEAN and rel_lml <= GATE_LML and rel_var <= GATE_VAR,
                "the multi-host exact posterior within the parity gates")
        require(e_counts["gram"] > 0, "the multi-host exact posterior launched K1")

        multihost.sync_hosts("start")
        multihost.sync_hosts("up", timeout_s=30)
        live = multihost.live_hosts()
        require(live == [0], f"live_hosts() == [0] ({live})")

        path = checkpoint.save(str(tmp / "multihost"), {"alpha": alpha, "step": 1}, step=1)
        back = checkpoint.restore(str(tmp / "multihost"),
                                  {"alpha": torch.zeros_like(alpha), "step": 0}, step=1)
        ckpt_equal = bool(torch.equal(back["alpha"], alpha)) and back["step"] == 1
        require(ckpt_equal and back["alpha"].device == alpha.device,
                "the per-rank checkpoint restored with equal bits on the device")

        x64 = torch.tensor(xe, dtype=torch.float64, device=device)
        y64 = torch.tensor(ye, dtype=torch.float64, device=device)
        cand = {"sigma": np.linspace(0.8, 1.5, MH_CANDIDATES),
                "lengthscale": np.linspace(0.5, 2.0, MH_CANDIDATES)}
        lml_fn = parallel.make_sharded_lml(kernel, mesh=mesh)

        def inject(attempt, out):
            if attempt == 1:
                out = out.copy()
                out[MH_LOST] = np.nan
            return out

        res, rd_seconds, rd_counts = _timed(lambda: parallel.run_with_redispatch(
            lambda b: lml_fn({k: torch.as_tensor(v) for k, v in b.items()}, x64, y64),
            cand, inject_failure=inject))
        want = [float(gp.log_marginal_likelihood(
            kernel, convert.params_from_numpy({k: v[i] for k, v in cand.items()},
                                              device=device, dtype=torch.float64), x64, y64))
                for i in range(MH_CANDIDATES)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res.values, want))
        emit("multihost", backend=backend, processes=1, mesh=list(mesh.shape), n=n, m=m, d=D,
             exact={"seconds": e_seconds, "seconds_float64": r_seconds, "rel_mean": rel_mean,
                    "rel_lml": rel_lml, "rel_var": rel_var, "launches": e_counts},
             live_hosts=live, checkpoint={"file": Path(path).name, "bitwise_equal": ckpt_equal},
             redispatch={"candidates": MH_CANDIDATES, "lost_on_attempt_1": MH_LOST,
                         "attempts": res.attempts, "redispatched": res.redispatched,
                         "seconds": rd_seconds, "max_rel_err_vs_lml": rel,
                         "launches": rd_counts},
             gates={"mean": GATE_MEAN, "lml": GATE_LML, "var": GATE_VAR, "redispatch": 1e-8})
        require(res.ok.all() and res.attempts == 2 and res.redispatched == 1,
                "every candidate recovered in 2 attempts, one re-dispatched")
        require(rel <= 1e-8, f"the re-dispatched LMLs within rel 1e-8 of the direct ({rel:.2e})")
    finally:
        multihost.shutdown()
    require(not dist.is_initialized(), "the group is gone after the multi-host phase")


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    device = torch.device("cuda", 0)
    # each phase's own generator, so that one that draws more leaves the
    # others' inputs as they were
    gen = lambda phase: np.random.default_rng([0, phase])  # noqa: E731
    phase_build()
    timings = phase_kernels(device, gen(3))
    timings.update(phase_kernels_gram(device, gen(4)))
    phase_exact(device, gen(5))
    phase_matrix_free(device, gen(6))
    timings.update(phase_kernels_bwd(device, gen(7)))
    train_data = phase_train_exact(device, gen(8))
    phase_train_large(device, gen(9))
    phase_classify_dense(device, gen(10))
    phase_classify_large(device, gen(11))
    phase_estimator_numpy(device, gen(12))
    timings["chol_inv_panel"] = phase_kernels_chol(device, gen(13))
    phase_chol_blocked(device)
    with tempfile.TemporaryDirectory() as tmp:
        phase_segmented(device, gen(13), Path(tmp))
        phase_segmented_laplace(device, gen(14), Path(tmp))
        phase_co2(device, gen(15), Path(tmp))
        phase_distributed(device, gen(16), Path(tmp))
        phase_distributed_classify(device, gen(17))
        phase_multihost(device, gen(18), Path(tmp))
    phase_train_exact_profile(device, *train_data)
    emit("path_launches", launches=PATH_LAUNCHES)
    for name in timings:
        require(PATH_LAUNCHES[name] > 0, f"{name} launched on the main paths")
    emit("run", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": PATH_LAUNCHES[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t.get("library_ms")}
        for name, t in timings.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
