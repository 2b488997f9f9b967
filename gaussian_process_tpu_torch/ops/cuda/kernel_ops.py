"""The dense kernel matrix K(x1, x2) and the matrix-free matvec
K(x1, x2) @ V on the GPU, differentiable, with their plain versions.

Torch counterpart of the JAX package's ``ops/pallas/kernel_ops.py``
(``gram``, ``gram_ad``, ``gram_matvec`` and its custom VJP). Hand-written
CUDA kernels do the work on a CUDA tensor:

- :func:`gram_cuda` (the tile gram, ``csrc/gram.cu``, replaces ``gram``) and
  :func:`gram_bwd_cuda` (its backward, ``csrc/gram_bwd.cu``, replaces the
  backward of ``gram_ad``);
- :func:`matvec_full_cuda` (full sweep, ``csrc/gram_matvec_full.cuh`` and
  ``csrc/gram_matvec.cu``, replaces ``_matvec_fwd_impl``): 3xTF32 on the
  tensor cores, columns in passes from :func:`full_passes`;
- :func:`matvec_sym_cuda` (same-set upper-triangle sweep,
  ``csrc/gram_matvec_sym.cu``, replaces ``_matvec_fwd_sym_impl``), over work
  items that :func:`sym_schedule` builds on the host;
- :func:`matvec_bwd_cuda` (the full backward sweep,
  ``csrc/gram_matvec_bwd.cuh``, replaces ``_matvec_bwd_sweep``): every
  entry once, G = ct V^T by register FMAs or 3xTF32 tensor-core MMAs
  (:func:`bwd_full_passes`), the x2 rows split over blocks to fill the card
  (:func:`bwd_full_split`); and :func:`matvec_bwd_sym_cuda` (the symmetric
  backward sweep, ``csrc/gram_matvec_bwd_sym.cuh``, the same function over
  the upper-triangle tiles for a same-set call that wants no x-gradient
  after a symmetric forward, a training step's).

The four sweeps take any d: past the widths at which a compiled leaf holds
x in registers, and past d = 8 for the interpreter, they take the sliced
layout (:func:`sliced_layout`, ``csrc/gram_matvec_slice.cuh``).

:func:`gram` is the port's one dense-gram dispatcher: fp32 CUDA inputs and
a stationary kernel take :func:`gram_ad` (``_GramFn``: the tile gram
forward and its backward kernel, as the JAX ``gram_ad``), anything else the
plain ``ops.gram``. :func:`gram_matvec` keeps the JAX package's sweep rule,
so both packages pick the same sweep for the same inputs, and runs through
``_GramMatvecFn``, whose backward gives the gradients in the coefficient
vector, x1, x2 and V. On a CPU tensor the Functions run the plain versions
(:func:`gram_reference` and :func:`gram_vjp_reference`,
:func:`gram_matvec_reference`, :func:`gram_matvec_vjp_reference`); on a
CUDA tensor they launch a kernel or raise. There is no fallback from one to
the other.

The kernel tree reaches the GPU as a postfix program: each instruction is
(opcode, offset into a coefficient vector). Leaves push a kernel value
computed from the tile's squared distance ``sq`` and, where needed,
``l2 = sqrt(sq)``; SCALE multiplies the top of the stack by a coefficient;
ADD and MUL combine the top two. The coefficients are derived from the
params tensors on the device (``-0.5 / l^2`` and so on), so a new
hyperparameter value needs no new build. :func:`eval_program` interprets the
same program in torch; the tests hold it against ``ops.gram``.

Gradients are taken at the coefficient level: the backward sweep returns
dL/dcoef, and the coefficients are differentiable functions of the params
tensors (:func:`encode`, :func:`coef_vector`), so autograd carries dL/dcoef
on to every hyperparameter of every family. CUDA needs derivatives only of
the leaves' closed forms in their coefficients.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.utils import profiling as _profiling

# opcodes: keep in sync with csrc/gram_matvec_common.cuh
OP_ZERO = 0
OP_RBF = 1
OP_MATERN12 = 2
OP_MATERN32 = 3
OP_MATERN52 = 4
OP_PERIODIC = 5
OP_DECAYED_PERIODIC = 6
OP_RQ = 7
OP_SCALE = 8
OP_ADD = 9
OP_MUL = 10
MAX_INSTR = 64
MAX_COEF = 256
MAX_STACK = 8
# the backward sweeps keep every instruction's value per entry: smaller limits
MAX_BWD_INSTR = 16
MAX_BWD_COEF = 16
# the symmetric backward sweep (csrc/gram_matvec_bwd_sym.cuh): its compiled
# pass widths (columns of V and ct a pass), and the float64 sums a compiled
# leaf writes per work item (S0, S1; the interpreter writes MAX_BWD_COEF),
# as the tile gram's backward (csrc/gram_bwd.cu) does per block
BWD_SYM_WIDTHS = (1, 2, 4, 6, 9, 12, 16)
BWD_SYM_LEAF_SUMS = 2
LOG2E = 1.4426950408889634
# the full backward sweep (csrc/gram_matvec_bwd.cuh): x1 rows of a block and
# x2 rows of a stage; the pass widths it compiles for G = ct V^T, by
# register FMAs (narrow) and by 3xTF32 MMAs (wide: whole 8-column k-steps,
# at most 72 columns so that nothing spills); r up to the widest FMA pass
# takes the FMAs (the crossover measured on the card, PERF.md). Its split
# of the x2 stages over blocks: at most BWD_FULL_MAX_SPLIT, a block's fixed
# work (its ct fragments, x1 rows and final sums) counted as
# BWD_FULL_BLOCK_COST stages
BWD_FULL_ROWS, BWD_FULL_STAGE = 128, 64
BWD_FULL_FMA = (1, 2, 4)
BWD_FULL_MMA = (8, 16, 24, 32, 48, 72)
BWD_FULL_MAX_SPLIT, BWD_FULL_BLOCK_COST = 32, 2
# the tile gram's backward (csrc/gram_bwd.cu): rows and columns of its
# tiles, which count its partials
GRAM_BWD_ROWS, GRAM_BWD_COLS = 32, 128
# the symmetric sweep's fixed point: each column's largest sum is scaled to
# at most 2^61, two bits below int64's range (csrc/gram_matvec_sym.cuh)
FIXED_POINT_BITS = 61
# the symmetric sweep's tiles and work items (csrc/gram_matvec_sym.cuh): 64-row
# tiles; at least SYM_RESIDENT items, the 256-thread blocks that 132 SMs hold
# at four a SM, and about SYM_ITEMS where the tiles allow, so that equal
# items leave little of the last wave idle
SYM_TILE = 64
SYM_RESIDENT = 132 * 4
SYM_ITEMS = 8 * SYM_RESIDENT
SYM_PASS_COLUMNS = 16  # columns of V per pass of the sweep
# single-leaf trees the sweeps evaluate as compiled instantiations
SYM_COMPILED_LEAVES = (OP_RBF, OP_MATERN12, OP_MATERN32, OP_MATERN52)
# the JAX package's output products of the matvec: "split3" (a 3-pass
# split product) and "highest" (full fp32); see gram_matvec
DOT_MODES = ("split3", "highest")
# the full sweep (csrc/gram_matvec_full.cuh): a pass holds one of
# FULL_TILES 8-column MMA tiles (its instantiations, at most 128 columns);
# x2 rows padded to a multiple of FULL_M_ALIGN
FULL_TILES = (1, 2, 3, 4, 5, 6, 8, 9, 12, 16)
FULL_M_ALIGN = 64
# the sweeps' layouts of x (sliced_layout): a compiled leaf holds x in
# registers up to the widest d its sweep compiles (K4's full sweep 4, K2, K3
# and K4's symmetric sweep 8), the interpreter reads x at full width
# from shared memory up to INTERP_FULL_WIDTH_D; past these the sweep stages
# x X_SLICE coordinates at a time, from a copy whose rows are d rounded up
# to whole slices (csrc/gram_matvec_slice.cuh)
FULL_HELD_D, SYM_HELD_D, BWD_SYM_HELD_D, BWD_FULL_HELD_D = 8, 8, 8, 4
INTERP_FULL_WIDTH_D = 8
X_SLICE = 32

# launches of each kernel, counted where the wrapper launches it: "gram"
# counts every launch of the tile gram, "gram_ad" those made by its
# differentiable wrapper, "gram_ad_bwd" each launch of its backward,
# "gram_matvec_full_sliced" those of K2's calls (all counted in
# "gram_matvec_full") that took the sliced layout, "chol_inv_panel" each
# call of the panel factor (ops/cuda/chol.py), whatever its count of device
# launches
launch_counts = {"gram": 0, "gram_ad": 0, "gram_ad_bwd": 0, "gram_matvec_full": 0,
                 "gram_matvec_full_sliced": 0, "gram_matvec_sym": 0, "gram_matvec_bwd": 0,
                 "gram_matvec_bwd_sym": 0, "chol_inv_panel": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ------------------------------------------------------------------ encoder


def encode(kernel: _k.Kernel, params: _k.Params) -> Tuple[List[Tuple[int, int]], list]:
    """Postfix program of a white-free stationary kernel tree.

    Returns ``(program, coefs)``: ``program`` is a list of
    ``(opcode, coef_offset)`` and ``coefs`` a list of scalars (tensors or
    floats) derived from ``params``. A White leaf inside the tree encodes as
    zero (``eval_from_distances`` semantics: callers add the white
    diagonal); it carries its variance as a coefficient that no opcode reads,
    so that every params leaf reaches the coefficient vector, and a
    gradient taken through it gives White's amplitude a zero, as autograd
    through the plain gram does.
    """
    program: List[Tuple[int, int]] = []
    coefs: list = []

    def leaf(op, *cs):
        program.append((op, len(coefs)))
        coefs.extend(cs)

    def walk(k, p):
        if isinstance(k, _k.RBF):
            leaf(OP_RBF, p["sigma"] ** 2, -0.5 / p["lengthscale"] ** 2)
        elif isinstance(k, _k.Matern):
            op, root = {0.5: (OP_MATERN12, 1.0), 1.5: (OP_MATERN32, math.sqrt(3.0)),
                        2.5: (OP_MATERN52, math.sqrt(5.0))}[k.nu]
            leaf(op, p["sigma"] ** 2, root / p["lengthscale"])
        elif isinstance(k, _k.Periodic):
            leaf(OP_PERIODIC, math.pi / p["period"], -2.0 / p["lengthscale"] ** 2)
        elif isinstance(k, _k.DecayedPeriodic):
            leaf(
                OP_DECAYED_PERIODIC,
                p["amplitude"] ** 2,
                -0.5 / p["decay"] ** 2,
                math.pi / p.get("period", 1.0),
                -2.0 / p["smoothness"] ** 2,
            )
        elif isinstance(k, _k.RationalQuadratic):
            alpha = p["alpha"]
            leaf(OP_RQ, p["amplitude"] ** 2, 0.5 / (alpha * p["lengthscale"] ** 2), -alpha)
        elif isinstance(k, _k.White):
            leaf(OP_ZERO, p["amplitude"] ** 2)
        elif isinstance(k, (_k.Sum, _k.Product)):
            combine = OP_ADD if isinstance(k, _k.Sum) else OP_MUL
            for idx, (c, pc) in enumerate(zip(k.children, p)):
                walk(c, pc)
                if idx > 0:
                    program.append((combine, 0))
        elif isinstance(k, _k.Scaled):
            walk(k.base, p["base"])
            program.append((OP_SCALE, len(coefs)))
            coefs.append(p["amplitude"] ** 2)
        else:
            raise ValueError(f"{type(k).__name__} is not a stationary kernel")

    walk(kernel, params)
    return program, coefs


def _stack_depth(program) -> int:
    depth = peak = 0
    for op, _ in program:
        if op in (OP_ADD, OP_MUL):
            depth -= 1
        elif op != OP_SCALE:
            depth += 1
            peak = max(peak, depth)
    return peak


def coef_vector(coefs, *, dtype, device) -> torch.Tensor:
    """The coefficient list as one tensor (no host round trip for tensors
    already on ``device``). Differentiable in every tensor coefficient, so
    a gradient in the vector flows back to the params it was derived from."""
    if not coefs:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.stack(
        [torch.as_tensor(c).to(device=device, dtype=dtype).reshape(()) for c in coefs]
    )


def eval_program(program, coef: torch.Tensor, sq: torch.Tensor,
                 l2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Torch interpreter of the postfix program (the CUDA tile evaluator's
    arithmetic, op for op). The tests check the encoding with it, and
    :func:`sym_fixed_point_scales` takes k(0) from it."""
    if l2 is None:
        l2 = torch.sqrt(sq)
    stack: List[torch.Tensor] = []
    for op, off in program:
        c = coef[off:]
        if op == OP_ADD:
            b = stack.pop()
            stack[-1] = stack[-1] + b
        elif op == OP_MUL:
            b = stack.pop()
            stack[-1] = stack[-1] * b
        elif op == OP_SCALE:
            stack[-1] = stack[-1] * c[0]
        elif op == OP_RBF:
            stack.append(c[0] * torch.exp(c[1] * sq))
        elif op == OP_MATERN12:
            stack.append(c[0] * torch.exp(-c[1] * l2))
        elif op == OP_MATERN32:
            s = c[1] * l2
            stack.append(c[0] * (1.0 + s) * torch.exp(-s))
        elif op == OP_MATERN52:
            s = c[1] * l2
            stack.append(c[0] * (1.0 + s + s * s * (1.0 / 3.0)) * torch.exp(-s))
        elif op == OP_PERIODIC:
            s = torch.sin(c[0] * l2)
            stack.append(torch.exp(c[1] * s * s))
        elif op == OP_DECAYED_PERIODIC:
            s = torch.sin(c[2] * l2)
            stack.append(c[0] * torch.exp(c[1] * sq + c[3] * s * s))
        elif op == OP_RQ:
            stack.append(c[0] * torch.exp(c[2] * torch.log1p(c[1] * sq)))
        elif op == OP_ZERO:
            stack.append(torch.zeros_like(sq))
        else:
            raise ValueError(f"unknown opcode {op}")
    return stack[0]


def gram_program(kernel: _k.Kernel, params: _k.Params, same: bool):
    """The tile gram's program: ``(program, coefs, white_idx)``. A same-set
    gram splits the top-level White terms off and appends their variance to
    the coefficients at ``white_idx`` (the kernel adds it on the global
    diagonal, as the JAX ``gram``'s index mask does); otherwise
    ``white_idx`` is -1 and a White leaf encodes as zero."""
    white = None
    if same:
        kernel, params, white = _k.split_white(kernel, params)
    program, coefs = ([(OP_ZERO, 0)], []) if kernel is None else encode(kernel, params)
    if white is None:
        return program, coefs, -1
    return program, [*coefs, white], len(coefs)


def nested_white(kernel: _k.Kernel) -> bool:
    """True if a White leaf sits anywhere but as a term of the top-level sum
    (the tile gram, like the JAX one, evaluates such a leaf as zero)."""
    terms = kernel.children if isinstance(kernel, _k.Sum) else (kernel,)

    def has_white(k):
        if isinstance(k, _k.White):
            return True
        if isinstance(k, (_k.Sum, _k.Product)):
            return any(has_white(c) for c in k.children)
        return isinstance(k, _k.Scaled) and has_white(k.base)

    return any(has_white(t) for t in terms if not isinstance(t, _k.White))


# ------------------------------------------------------------ plain version


def gram_reference(kernel: _k.Kernel, params: _k.Params, x1: torch.Tensor,
                   x2: Optional[torch.Tensor] = None, *, method: str = "dot") -> torch.Tensor:
    """The tile gram's plain version: ``ops.gram``."""
    return _k.gram(kernel, params, x1, x2, method=method)


def gram_matvec_reference(
    kernel: _k.Kernel,
    params: _k.Params,
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    same: bool = False,
    row_chunk: int = 4096,
) -> torch.Tensor:
    """Plain PyTorch K(x1, x2) @ v: ``ops.gram`` on row blocks of x1, times
    v, concatenated. ``same=True`` means x2 is x1 (``x2`` may be None) and
    White's diagonal is added. Row blocks keep the memory at
    ``row_chunk * m`` entries, so it runs where a dense K would not fit."""
    x1 = _k._dist._as_2d(x1)
    vec_in = v.ndim == 1
    vv = v[:, None] if vec_in else v
    white_var = None
    if same:
        kernel, params, white_var = _k.split_white(kernel, params)
        x2 = x1
    x2 = _k._dist._as_2d(x2)
    if kernel is None:
        out = white_var * vv
    else:
        out = torch.cat([
            _k.gram(kernel, params, x1[i:i + row_chunk], x2) @ vv
            for i in range(0, x1.shape[0], row_chunk)
        ])
        if white_var is not None:
            out = out + white_var * vv
    return out[:, 0] if vec_in else out


def _safe_half_inv(l2: torch.Tensor) -> torch.Tensor:
    """0.5 / l2, and 0 where l2 = 0 (coincident points add nothing to the
    x-gradient: see ``leaf_grad`` in ``csrc/gram_matvec_common.cuh``)."""
    pos = l2 > 0
    return torch.where(pos, 0.5 / torch.where(pos, l2, torch.ones_like(l2)),
                       torch.zeros_like(l2))


def _leaf_grad(op: int, c: torch.Tensor, sq: torch.Tensor, l2: Optional[torch.Tensor]):
    """A leaf's value, its derivatives in its coefficients and dk/dsq: the
    plain version of ``leaf_grad`` in ``csrc/gram_matvec_common.cuh``,
    formula for formula."""
    if op == OP_RBF:
        e = torch.exp(c[1] * sq)
        k = c[0] * e
        return k, [e, k * sq], k * c[1]
    if op == OP_MATERN12:
        e = torch.exp(-c[1] * l2)
        k = c[0] * e
        return k, [e, -k * l2], -k * c[1] * _safe_half_inv(l2)
    if op == OP_MATERN32:
        s = c[1] * l2
        e = torch.exp(-s)
        ce = c[0] * e
        return ce * (1.0 + s), [(1.0 + s) * e, -ce * s * l2], -0.5 * ce * c[1] * c[1]
    if op == OP_MATERN52:
        s = c[1] * l2
        e = torch.exp(-s)
        p = 1.0 + s + s * s * (1.0 / 3.0)
        ce = c[0] * e
        return (ce * p, [p * e, -ce * s * (1.0 + s) * (1.0 / 3.0) * l2],
                -ce * c[1] * c[1] * (1.0 + s) * (1.0 / 6.0))
    if op == OP_PERIODIC:
        arg = c[0] * l2
        sn, cs = torch.sin(arg), torch.cos(arg)
        k = torch.exp(c[1] * sn * sn)
        dk_darg = k * c[1] * 2.0 * sn * cs
        return k, [dk_darg * l2, k * sn * sn], dk_darg * c[0] * _safe_half_inv(l2)
    if op == OP_DECAYED_PERIODIC:
        arg = c[2] * l2
        sn, cs = torch.sin(arg), torch.cos(arg)
        e = torch.exp(c[1] * sq + c[3] * sn * sn)
        k = c[0] * e
        dk_darg = k * c[3] * 2.0 * sn * cs
        return (k, [e, k * sq, dk_darg * l2, k * sn * sn],
                k * c[1] + dk_darg * c[2] * _safe_half_inv(l2))
    if op == OP_RQ:
        u = c[1] * sq
        lg = torch.log1p(u)
        e = torch.exp(c[2] * lg)
        k = c[0] * e
        kc2 = k * c[2] / (1.0 + u)
        return k, [e, kc2 * sq, k * lg], kc2 * c[1]
    if op == OP_ZERO:
        zero = torch.zeros_like(sq)
        return zero, [], zero
    raise ValueError(f"unknown opcode {op}")


def _program_vjp(program, coef: torch.Tensor, sq: torch.Tensor,
                 l2: Optional[torch.Tensor], g: torch.Tensor):
    """Reverse pass through the postfix program on a tile, with root
    adjoint ``g``: returns (sum over the tile of g dk/dcoef, g dk/dsq). The
    plain version of ``tree_grad`` in ``csrc/gram_matvec_common.cuh``."""
    vals, kids, leaves, stack = [], [], {}, []
    for k, (op, off) in enumerate(program):
        if op in (OP_ADD, OP_MUL):
            rhs, lhs = stack.pop(), stack.pop()
            kids.append((lhs, rhs))
            vals.append(vals[lhs] + vals[rhs] if op == OP_ADD else vals[lhs] * vals[rhs])
        elif op == OP_SCALE:
            child = stack.pop()
            kids.append((child,))
            vals.append(vals[child] * coef[off])
        else:
            val, dcs, dsq = _leaf_grad(op, coef[off:], sq, l2)
            kids.append(())
            vals.append(val)
            leaves[k] = (dcs, dsq)
        stack.append(k)
    d_coef = [torch.zeros((), dtype=coef.dtype, device=coef.device)] * coef.numel()
    adj = [None] * len(program)
    adj[-1] = g
    gsq = torch.zeros_like(sq)
    for k in range(len(program) - 1, -1, -1):
        a = adj[k]
        if a is None:
            continue
        op, off = program[k]

        def send(i, val):
            adj[i] = val if adj[i] is None else adj[i] + val

        if op == OP_ADD:
            send(kids[k][0], a)
            send(kids[k][1], a)
        elif op == OP_MUL:
            lhs, rhs = kids[k]
            send(lhs, a * vals[rhs])
            send(rhs, a * vals[lhs])
        elif op == OP_SCALE:
            (child,) = kids[k]
            send(child, a * coef[off])
            d_coef[off] = d_coef[off] + torch.sum(a * vals[child])
        else:
            dcs, dsq = leaves[k]
            for j, dc in enumerate(dcs):
                d_coef[off + j] = d_coef[off + j] + torch.sum(a * dc)
            gsq = gsq + a * dsq
    return torch.stack(d_coef), gsq


def gram_matvec_vjp_reference(
    program,
    coef: torch.Tensor,
    x1c: torch.Tensor,
    x2c: torch.Tensor,
    v: torch.Tensor,
    ct: torch.Tensor,
    *,
    need_l2: bool = True,
    want_dx: bool = True,
    row_chunk: Optional[int] = None,
):
    """Plain PyTorch version of both backward sweeps (the full and the
    symmetric one compute the same function): for L = <ct, K(x1, x2) v>
    returns (dL/dcoef, dL/dx1 or None), with the kernel's arithmetic (direct
    squared differences, hand-written leaf derivatives, the same rule at
    coincident points). Row blocks of ``row_chunk`` rows bound the memory
    (None: about 2^24 entries each, fewer above d = 4, so that the block's
    d coordinate differences stay near 2^26 values at any d)."""
    n, d = x1c.shape
    m = x2c.shape[0]
    if row_chunk is None:
        row_chunk = max(1, (1 << 26) // (m * max(d, 4)))
    d_coef = torch.zeros(coef.numel(), dtype=coef.dtype, device=coef.device)
    d_x1 = torch.empty((n, d), dtype=x1c.dtype, device=x1c.device) if want_dx else None
    for i in range(0, n, row_chunk):
        a = x1c[i:i + row_chunk]
        diffs = [a[:, k:k + 1] - x2c[None, :, k] for k in range(d)]
        sq = sum(t * t for t in diffs)
        l2 = torch.sqrt(sq) if need_l2 else None
        g = ct[i:i + row_chunk] @ v.T
        dc, gsq = _program_vjp(program, coef, sq, l2, g)
        d_coef += dc
        if want_dx:
            for k in range(d):
                d_x1[i:i + row_chunk, k] = 2.0 * torch.sum(gsq * diffs[k], dim=1)
    return d_coef, d_x1


def gram_vjp_reference(
    program,
    coef: torch.Tensor,
    x1c: torch.Tensor,
    x2c: Optional[torch.Tensor],
    ct: torch.Tensor,
    *,
    white_idx: int = -1,
    need_l2: bool = True,
    want_dx1: bool = True,
    want_dx2: bool = False,
    row_chunk: Optional[int] = None,
):
    """Plain PyTorch version of the tile gram's backward (``gram_bwd_cuda``):
    for L = <ct, K(x1, x2)>, with K the tile gram's function of
    :func:`gram_program`'s ``(program, coef, white_idx)``, returns
    (dL/dcoef, dL/dx1 or None, dL/dx2 or None), with the kernel's arithmetic
    (direct differences, hand-written leaf derivatives, no contribution from
    a coincident pair to dx). ``x2c=None`` is the same set: White's
    coefficient gets the trace of ct, and dL/dx1 is the sum of both roles
    (``want_dx2`` must be False). Row blocks of ``row_chunk`` rows bound the
    memory (None: about 2^24 entries each, fewer above d = 4, as in
    :func:`gram_matvec_vjp_reference`)."""
    same = x2c is None
    if same and want_dx2:
        raise ValueError("a same-set gram has one point set: ask for dx1")
    x2c = x1c if same else x2c
    n, d = x1c.shape
    m = x2c.shape[0]
    if row_chunk is None:
        row_chunk = max(1, (1 << 26) // (m * max(d, 4)))
    d_coef = torch.zeros(coef.numel(), dtype=coef.dtype, device=coef.device)
    d_x1 = torch.empty((n, d), dtype=x1c.dtype, device=x1c.device) if want_dx1 else None
    col = torch.zeros((m, d), dtype=x1c.dtype, device=x1c.device) if want_dx2 or (
        same and want_dx1) else None
    for i in range(0, n, row_chunk):
        diffs = [x1c[i:i + row_chunk, k:k + 1] - x2c[None, :, k] for k in range(d)]
        sq = sum(t * t for t in diffs)
        dc, gsq = _program_vjp(program, coef, sq, torch.sqrt(sq) if need_l2 else None,
                               ct[i:i + row_chunk])
        d_coef += dc
        for k in range(d):
            if want_dx1:
                d_x1[i:i + row_chunk, k] = 2.0 * torch.sum(gsq * diffs[k], dim=1)
            if col is not None:
                col[:, k] -= 2.0 * torch.sum(gsq * diffs[k], dim=0)
    if same:
        if white_idx >= 0:
            d_coef[white_idx] += torch.sum(torch.diagonal(ct))
        if want_dx1:
            d_x1 = d_x1 + col
        return d_coef, d_x1, None
    return d_coef, d_x1, col


# ------------------------------------------------------------ CUDA wrappers


def _check_cuda_f32(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _prog_tensor(program, max_instr: int, max_coef: int, n_coef: int, device) -> torch.Tensor:
    if len(program) > max_instr or n_coef > max_coef:
        raise ValueError(
            f"kernel tree too large for the CUDA kernel: {len(program)} instructions "
            f"(at most {max_instr}), {n_coef} coefficients (at most {max_coef})"
        )
    if _stack_depth(program) > MAX_STACK:
        raise ValueError("kernel tree nested too deeply for the CUDA kernel")
    return _program_on_device(tuple(program), torch.device(device))


@functools.lru_cache(maxsize=64)
def _program_on_device(program: tuple, device: torch.device) -> torch.Tensor:
    """The program as an int32 device tensor, copied once per tree and
    device: a copy from pageable host memory waits for the stream, which
    would cost a sub-millisecond kernel (the tile gram) a round trip per
    launch. The kernels only read it."""
    return torch.tensor(program, dtype=torch.int32).reshape(-1).to(device)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sliced_layout(route: int, d: int, held_d: int) -> bool:
    """Whether a matrix-free sweep (K2, K3, both K4 sweeps) stages x in
    slices of X_SLICE coordinates: for a compiled leaf (``route``, as
    :func:`sym_route` gives it) past ``held_d``, the widest x the sweep
    holds in registers (FULL_HELD_D and its siblings: 8, or 4 for K4's
    full sweep), for the interpreter past INTERP_FULL_WIDTH_D. The sliced
    block's shared memory does not grow with d, so every d runs. Against
    the loop over d at full width (D = 0) it ran 1.3-2.1x faster at d = 9
    and 10-16x at d = 64 on every sweep, K3 at d = 9 aside (1.5% slower;
    ``PERF.md`` §7), so no compiled leaf runs D = 0; the interpreter keeps
    it up to d = 8, where the sliced layout has not been timed. A held
    width of 8 spares d = 5-8 a slice that is three quarters zeros or
    more: K2 at d = 8 ran 2.0x faster held than sliced (``PERF.md`` §6)."""
    return d > (held_d if route else INTERP_FULL_WIDTH_D)


def _slice_copy(rows: int, d: int, x: torch.Tensor) -> torch.Tensor:
    """Scratch for the sliced layout's prescaled copy of x: ``rows`` rows of
    d rounded up to whole slices (filled by the kernel)."""
    return torch.empty((rows, _round_up(d, X_SLICE)), dtype=torch.float32, device=x.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward_args(program, coef, x):
    """The library and the program on x's device."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    lib = _build.load()
    prog = _prog_tensor(program, MAX_INSTR, MAX_COEF, coef.numel(), x.device)
    return lib, prog


def _gram_shapes(coef, x1c, x2c, white_idx):
    """``(x2c, same, n, m, d)`` of a tile-gram call (x2c=None: the same set),
    after the checks both its kernels share."""
    same = x2c is None
    x2c = x1c if same else x2c
    _check_cuda_f32(coef=coef, x1=x1c, x2=x2c)
    n, d = x1c.shape
    m = x2c.shape[0]
    if x2c.shape[1] != d:
        raise ValueError(f"x1 has {d} columns, x2 {x2c.shape[1]}")
    if white_idx >= 0 and not same:
        raise ValueError("White's diagonal belongs to a same-set gram only")
    return x2c, same, n, m, d


def _vec16(t: torch.Tensor, m: int) -> int:
    """1 if the kernel may move t's rows of m floats 16 bytes at a time."""
    return int(m % 4 == 0 and t.data_ptr() % 16 == 0)


def gram_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: Optional[torch.Tensor],
              *, white_idx: int, need_l2: bool) -> torch.Tensor:
    """K(x1, x2) (n, m) by the tile-gram CUDA kernel, for the postfix
    ``program`` over ``coef`` (:func:`gram_program`). Takes centred,
    contiguous fp32 CUDA tensors x1c (n, d) and x2c (m, d); ``x2c=None`` is
    the same set, where ``coef[white_idx]`` (if ``white_idx >= 0``) goes on
    the diagonal. One RBF or Matern leaf runs compiled (:func:`sym_route`),
    as the matrix-free sweeps evaluate it. Raises on anything else."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    x2c, same, n, m, d = _gram_shapes(coef, x1c, x2c, white_idx)
    lib = _build.load()
    prog = _prog_tensor(program, MAX_INSTR, MAX_COEF, coef.numel(), x1c.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x1c.device)
    with torch.cuda.device(x1c.device):
        err = lib.gm_gram(
            x1c.data_ptr(), x2c.data_ptr(), out.data_ptr(), prog.data_ptr(), len(program),
            coef.data_ptr(), coef.numel(), int(white_idx), sym_route(program), n, m, d,
            int(need_l2), _vec16(out, m), _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_gram launch failed: cudaError {err}")
    launch_counts["gram"] += 1
    return out


def gram_bwd_dx_scale(program, coef: torch.Tensor) -> torch.Tensor:
    """The factor that turns the x-gradient sums of the tile gram's backward
    (``csrc/gram_bwd.cu``) and of the full backward sweep
    (``csrc/gram_matvec_bwd.cuh``), sum q (a - b) over an entry's weights q,
    into dL/dx1, as a float64 0-d tensor on coef's device: 2 for the
    interpreter (q = ct dk/dsq on unscaled x; the sweep's ct is its G). A
    compiled leaf's q = ct phi on x
    prescaled by s (``leaf_bwd_terms``) gives dk/dx_i = 2 dk/dsq (x_i - x_j):
    RBF 2 c0 c1 / s with s = sqrt(-c1 log2 e); a Matern's x' = c1 x,
    -c0 c1 (1/2 and 3/2) or -c0 c1 / 3 (5/2)."""
    route = sym_route(program)
    if route == 0:
        return torch.tensor(2.0, dtype=torch.float64, device=coef.device)
    c0, c1 = coef[0].to(torch.float64), coef[1].to(torch.float64)
    if route == OP_RBF:
        return 2.0 * c0 * c1 / torch.sqrt(-c1 * LOG2E)
    return -c0 * c1 / (3.0 if route == OP_MATERN52 else 1.0)


def gram_bwd_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: Optional[torch.Tensor],
                  ct: torch.Tensor, *, white_idx: int, need_l2: bool, want_dx1: bool,
                  want_dx2: bool = False):
    """The tile gram's backward by the CUDA kernel (``csrc/gram_bwd.cu``):
    for L = <ct, K(x1, x2)>, (dL/dcoef, dL/dx1 or None, dL/dx2 or None),
    the function of :func:`gram_vjp_reference`. Centred contiguous fp32 CUDA
    tensors x1c (n, d), x2c (m, d) or None (the same set: White's
    coefficient gets the trace of ct, dL/dx1 sums both roles), ct (n, m);
    any tree the forward takes. The route (:func:`sym_route`) is chosen
    here; the kernel sizes its grid to the card (it reports its count of
    blocks). It writes one float64 partial per block and sum, and fp32
    partials of the x-gradients per tile, with no atomics; they are summed
    here in a fixed order and rescaled (:func:`bwd_sym_coef`,
    :func:`gram_bwd_dx_scale`), so a rerun gives equal bits."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    x2c, same, n, m, d = _gram_shapes(coef, x1c, x2c, white_idx)
    _check_cuda_f32(ct=ct)
    if ct.shape != (n, m):
        raise ValueError(f"ct shape {tuple(ct.shape)} is not ({n}, {m})")
    if same and want_dx2:
        raise ValueError("a same-set gram has one point set: ask for dx1")
    lib = _build.load()
    prog = _prog_tensor(program, MAX_INSTR, MAX_COEF, coef.numel(), x1c.device)
    route = sym_route(program)
    # a partial row per block (at most one a tile): the route's sums, the trace
    width = (BWD_SYM_LEAF_SUMS if route else coef.numel()) + 1
    tiles = -(-n // GRAM_BWD_ROWS) * -(-m // GRAM_BWD_COLS)
    part = torch.empty((tiles, width), dtype=torch.float64, device=x1c.device)
    blocks = ctypes.c_longlong(0)
    # row sums of x1's entries per column tile, column sums per row tile;
    # a same-set dx needs both roles
    rows_wanted, cols_wanted = want_dx1, want_dx2 or (same and want_dx1)
    pdx1 = torch.empty((-(-m // GRAM_BWD_COLS), n, d), dtype=torch.float32,
                       device=x1c.device) if rows_wanted else None
    pdx2 = torch.empty((-(-n // GRAM_BWD_ROWS), m, d), dtype=torch.float32,
                       device=x1c.device) if cols_wanted else None
    with torch.cuda.device(x1c.device):
        err = lib.gm_gram_bwd(
            x1c.data_ptr(), x2c.data_ptr(), ct.data_ptr(), part.data_ptr(),
            None if pdx1 is None else pdx1.data_ptr(), None if pdx2 is None else pdx2.data_ptr(),
            prog.data_ptr(), len(program), coef.data_ptr(), coef.numel(), int(white_idx), route,
            n, m, d, int(need_l2), _vec16(ct, m), ctypes.byref(blocks), _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_gram_bwd launch failed: cudaError {err}")
    launch_counts["gram_ad_bwd"] += 1
    sums = part[:blocks.value].sum(dim=0)
    d_coef = bwd_sym_coef(program, coef, sums[:width - 1])
    if white_idx >= 0:
        d_coef[white_idx] += sums[width - 1].to(d_coef.dtype)
    if pdx1 is None and pdx2 is None:
        return d_coef, None, None
    scale = gram_bwd_dx_scale(program, coef).to(torch.float32)
    d_x1 = scale * pdx1.sum(dim=0) if rows_wanted else None
    d_x2 = -scale * pdx2.sum(dim=0) if cols_wanted else None
    if same:
        return d_coef, (d_x1 + d_x2 if want_dx1 else None), None
    return d_coef, d_x1, d_x2


def full_passes(r: int) -> Tuple[int, int]:
    """The full sweep's column passes for an r-column V: ``(passes,
    columns a pass)``: the fewest passes of at most 128 columns, each a
    whole number of 8-column MMA tiles, the least of FULL_TILES that holds
    its even share of r. r = 1, 9, 65, 72, 130, 512
    give (1, 8), (1, 16), (1, 72), (1, 72), (2, 72), (4, 128)."""
    tiles = -(-r // 8)
    passes = -(-tiles // FULL_TILES[-1])
    share = -(-tiles // passes)
    return passes, 8 * min(t for t in FULL_TILES if t >= share)


def full_columns(r: int) -> int:
    """The columns the full sweep computes for an r-column V
    (:func:`full_passes`): r = 1, 9, 65, 72, 130, 512 give 8, 16, 72, 72,
    144, 512."""
    passes, width = full_passes(r)
    return passes * width


def matvec_full_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: torch.Tensor,
                     v: torch.Tensor, *, need_l2: bool) -> torch.Tensor:
    """K(x1, x2) @ v by the full-sweep CUDA kernel, for the postfix
    ``program`` over the coefficient vector ``coef`` (:func:`encode`). Takes
    centred, contiguous fp32 CUDA tensors x1c (n, d), x2c (m, d), v (m, r),
    any d and r; raises on anything else. The product is 3xTF32 on the
    tensor cores under both ``dot_mode``s (:func:`gram_matvec` says why), in
    the passes of :func:`full_passes`, with a compiled route for one RBF or
    Matern leaf (:func:`sym_route`). x is held in registers by a compiled
    leaf at d <= 8 (zero-padded to 4 or 8 coordinates) and read at full
    width by the interpreter at d <= 8; every other d takes the sliced
    layout (:func:`sliced_layout`). One call is two device launches (a
    staging pass that splits V, then the sweep; three sliced, with x1's
    prescaled copy) and counts one in ``launch_counts["gram_matvec_full"]``,
    and a sliced one also in ``"gram_matvec_full_sliced"``. Every output
    row is written once, so a rerun gives equal bits."""
    _check_cuda_f32(coef=coef, x1=x1c, x2=x2c, v=v)
    n, d = x1c.shape
    m, r = v.shape
    if x2c.shape != (m, d):
        raise ValueError(f"x2 shape {tuple(x2c.shape)} does not match v {tuple(v.shape)}")
    out = torch.empty((n, r), dtype=torch.float32, device=x1c.device)
    route = sym_route(program)
    passes, width = full_passes(r)
    nt = width // 8
    lib, prog = _forward_args(program, coef, x1c)
    sliced = int(sliced_layout(route, d, FULL_HELD_D))
    m_pad = _round_up(m, FULL_M_ALIGN)
    x1s = _slice_copy(_round_up(n, 128), d, x1c) if sliced else None
    x2s = torch.empty((m_pad, lib.gm_full_tc_x_width(route, d, sliced)), dtype=torch.float32,
                      device=x1c.device)
    vf = torch.empty((passes, m_pad, 2 * width), dtype=torch.float32, device=x1c.device)
    with torch.cuda.device(x1c.device):
        err = lib.gm_matvec_full_tc(
            x1c.data_ptr(), x2c.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(x1s),
            x2s.data_ptr(), vf.data_ptr(), prog.data_ptr(), len(program), coef.data_ptr(),
            coef.numel(), route, passes, nt, n, m, m_pad, d, r, int(need_l2), sliced,
            _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_full_tc launch failed: cudaError {err}")
    launch_counts["gram_matvec_full"] += 1
    launch_counts["gram_matvec_full_sliced"] += sliced
    return out


def sym_fixed_point_scales(program, coef: torch.Tensor,
                           v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The symmetric sweep's fixed-point scales (``csrc/gram_matvec_sym.cuh``):
    ``(scale, flag)``, both (r,) on v's device. ``scale[c]`` is 2^e_c
    (float64), the largest power of two with
    k(0) sum_j |v[j, c]| 2^e_c <= 2^FIXED_POINT_BITS, where k(0) is the
    program's value at distance 0, which bounds |k(r)| for the
    white-free stationary trees that :func:`encode` builds. ``flag[c]``
    (int32) is 1 where that bound is not finite (NaN or Inf in v or in the
    coefficients): the kernel then writes NaN into the column. A zero bound
    takes the scale 1, and e_c is clamped to +-1000 so that 2^e_c stays a
    finite double. Torch reductions on the device, deterministic for a
    given shape, so a rerun picks the same scales."""
    zero = torch.zeros(1, dtype=torch.float64, device=v.device)
    k0 = eval_program(program, coef.to(torch.float64), zero)[0]
    bound = torch.abs(k0) * torch.sum(torch.abs(v), dim=0, dtype=torch.float64)
    finite = torch.isfinite(bound)
    usable = finite & (bound > 0)
    e = torch.floor(FIXED_POINT_BITS - torch.log2(torch.where(usable, bound,
                                                               torch.ones_like(bound))))
    e = torch.where(usable, e, torch.zeros_like(e)).clamp(-1000.0, 1000.0)
    return torch.exp2(e), (~finite).to(torch.int32)


def sym_columns(r: int) -> int:
    """The columns the symmetric sweep computes for an r-column V: the next
    power of two at or above r up to 16 (one pass of that width), above 16
    r rounded up to passes of 16. r = 1, 3, 9, 64 give 1, 4, 16, 64. The
    wrapper hands the kernel the pass width, :func:`_sym_pass`."""
    if r <= SYM_PASS_COLUMNS:
        return 1 << max(0, (r - 1).bit_length())
    return _round_up(r, SYM_PASS_COLUMNS)


def _sym_pass(r: int) -> int:
    return min(sym_columns(r), SYM_PASS_COLUMNS)


def sym_route(program) -> int:
    """The route of the symmetric and the full sweep for a postfix
    program: the leaf's opcode for a tree of one RBF or Matern leaf (a
    compiled instantiation), else 0 (the interpreter)."""
    if len(program) == 1 and program[0][0] in SYM_COMPILED_LEAVES:
        return program[0][0]
    return 0


@functools.lru_cache(maxsize=32)
def sym_schedule(n: int, items_wanted: int = SYM_ITEMS) -> Tuple[Tuple[int, int, int], ...]:
    """The symmetric sweep's work items for n rows: ``(ti, j0, j1)``, the
    tiles (ti, j) with j0 <= j < j1 of row strip ti, walked in ascending j
    by one block. The p = ceil(n / 64) strips hold the p (p + 1) / 2 upper
    tiles (ti <= j). Strip i (p - i tiles) is paired with strip p - 1 - i
    (i + 1 tiles), so every pair holds p + 1 tiles (the middle strip of an
    odd p, (p + 1) / 2, stands alone). Each pair is cut into k segments of
    equal length (within one tile), k the least that gives about
    ``items_wanted`` items in all and never more segments than tiles; a
    segment that spans the two strips of its pair is two items. Every upper
    tile lies in exactly one item."""
    p = -(-n // SYM_TILE)
    groups = [(i, p - 1 - i) for i in range(p // 2)]
    if p % 2:
        groups.append((p // 2,))
    k_want = max(1, -(-items_wanted // len(groups)))
    items = []
    for strips in groups:
        lengths = [p - s for s in strips]
        total = sum(lengths)
        k = min(k_want, total)
        cuts = [total * q // k for q in range(k + 1)]
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            start = 0
            for s, length in zip(strips, lengths):
                a, b = max(lo, start), min(hi, start + length)
                if a < b:  # tiles [a, b) of the pair fall in strip s
                    items.append((s, s + a - start, s + b - start))
                start += length
    return tuple(items)


def bwd_sym_passes(r: int) -> Tuple[int, int]:
    """The symmetric backward sweep's column passes for r columns of V and
    ct: ``(passes, columns a pass)``, the fewest passes of at most 16
    columns, each the least of BWD_SYM_WIDTHS that holds its even share of
    r. r = 1, 3, 8, 9, 16, 17, 33, 64 give (1, 1), (1, 4), (1, 9), (1, 9),
    (1, 16), (2, 9), (3, 12), (4, 16)."""
    passes = -(-r // BWD_SYM_WIDTHS[-1])
    share = -(-r // passes)
    return passes, min(w for w in BWD_SYM_WIDTHS if w >= share)


def bwd_sym_coef(program, coef: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """dL/dcoef, in coef's dtype, from the float64 sums of the symmetric
    backward sweep (``csrc/gram_matvec_bwd_sym.cuh``) or of the tile gram's
    backward (``csrc/gram_bwd.cu``). The interpreter's sums are dL/dcoef
    itself. A compiled leaf c0 k'(x') (:func:`sym_route`) sums
    S0 = sum w f and S1 = sum w h over its prescaled distances, so
    dL/dc0 = S0 and dL/dc1 = c0 S1 / (-c1 log2 e) for RBF (x scaled by
    sqrt(-c1 log2 e)) or c0 S1 / c1 for a Matern (x scaled by c1); any
    coefficient after the leaf's two (a same-set gram's White variance)
    gets zero. Torch ops on the device, no host round trip."""
    route = sym_route(program)
    if route == 0:
        return sums[:coef.numel()].to(coef.dtype)
    c0, c1 = coef[0].to(torch.float64), coef[1].to(torch.float64)
    per_c1 = -c1 * LOG2E if route == OP_RBF else c1
    d_coef = torch.stack([sums[0], c0 * sums[1] / per_c1])
    if coef.numel() > 2:
        d_coef = torch.cat([d_coef, d_coef.new_zeros(coef.numel() - 2)])
    return d_coef.to(coef.dtype)


@functools.lru_cache(maxsize=32)
def _sym_items_on_device(n: int, device: torch.device) -> torch.Tensor:
    """:func:`sym_schedule` as an int32 (items, 3) device tensor, copied
    once per n and device (as :func:`_program_on_device`)."""
    return torch.tensor(sym_schedule(n), dtype=torch.int32).reshape(-1, 3).to(device)


def matvec_sym_cuda(program, coef: torch.Tensor, xc: torch.Tensor, v: torch.Tensor, *,
                    need_l2: bool) -> torch.Tensor:
    """K(x, x) @ v by the upper-triangle CUDA kernel (centred contiguous
    fp32 CUDA tensors xc (n, d), v (n, r), any d and r; ``program`` and
    ``coef`` as in :func:`matvec_full_cuda`). The route (:func:`sym_route`),
    the layout (x in registers for a compiled leaf at d <= 8, at full width
    for the interpreter at d <= 8, else sliced: :func:`sliced_layout`) and
    the work items
    (:func:`sym_schedule`) are chosen here, before the launch; an
    instantiation that fails to build or launch raises. The kernel sums in
    64-bit fixed point (:func:`sym_fixed_point_scales`), so the same inputs
    give the same bits on every run. One call is two device launches (the
    sweep and its finishing pass; three sliced, x's prescaled copy first)
    and counts one launch."""
    _check_cuda_f32(coef=coef, x=xc, v=v)
    n, d = xc.shape
    if v.shape[0] != n:
        raise ValueError(f"v has {v.shape[0]} rows, x has {n}")
    r = v.shape[1]
    lib, prog = _forward_args(program, coef, xc)
    route = sym_route(program)
    sliced = int(sliced_layout(route, d, SYM_HELD_D))
    xs = _slice_copy(_round_up(n, SYM_TILE), d, xc) if sliced else None
    items = _sym_items_on_device(n, xc.device)
    scale, flag = sym_fixed_point_scales(program, coef, v)
    acc = torch.zeros((n, r), dtype=torch.int64, device=xc.device)
    out = torch.empty((n, r), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        err = lib.gm_matvec_sym(
            xc.data_ptr(), v.data_ptr(), out.data_ptr(), acc.data_ptr(), flag.data_ptr(),
            scale.data_ptr(), items.data_ptr(), items.shape[0], prog.data_ptr(), len(program),
            coef.data_ptr(), coef.numel(), route, _sym_pass(r), n, d, r, int(need_l2),
            _ptr(xs), sliced, _stream(xc.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_sym launch failed: cudaError {err}")
    launch_counts["gram_matvec_sym"] += 1
    return out


def bwd_full_passes(r: int) -> Tuple[int, int, bool]:
    """The full backward sweep's column passes for r columns of V and ct:
    ``(passes, columns a pass, mma)``. Up to BWD_FULL_FMA[-1] columns one
    pass of the least FMA width that holds r (G by register FMAs); above,
    3xTF32 MMA passes: the fewest of at most 72 columns, each the least of
    BWD_FULL_MMA that holds its even share of r. r = 1, 3, 8, 9, 65, 130,
    512 give (1, 1, False), (1, 4, False), (1, 8, True), (1, 16, True),
    (1, 72, True), (2, 72, True), (8, 72, True)."""
    if r <= BWD_FULL_FMA[-1]:
        return 1, min(w for w in BWD_FULL_FMA if w >= r), False
    tiles = -(-r // 8)
    passes = -(-tiles // (BWD_FULL_MMA[-1] // 8))
    share = 8 * -(-tiles // passes)
    return passes, min(w for w in BWD_FULL_MMA if w >= share), True


def bwd_full_split(n: int, m: int, resident: int) -> int:
    """How many parts the full backward sweep splits its x2 stages into
    (blockIdx.y), for ceil(n / 128) row blocks, ceil(m / 64) stages and
    ``resident`` blocks that the card holds at once: the s in
    1 .. min(stages, BWD_FULL_MAX_SPLIT) with the least
    ceil(rows s / resident) (ceil(stages / s) + BWD_FULL_BLOCK_COST), the
    waves times a block's length in stages; the least such s. n = m = 4096
    on 132 blocks splits in 4 (128 blocks, one wave)."""
    rows = -(-n // BWD_FULL_ROWS)
    stages = -(-m // BWD_FULL_STAGE)
    resident = max(1, resident)

    def cost(s):
        return -(-rows * s // resident) * (-(-stages // s) + BWD_FULL_BLOCK_COST)

    return min(range(1, min(stages, BWD_FULL_MAX_SPLIT) + 1), key=lambda s: (cost(s), s))


@functools.lru_cache(maxsize=64)
def _bwd_full_resident(route: int, mma: bool, width: int, d: int, want_dx: bool, sliced: int,
                       device: torch.device) -> int:
    """The blocks of the full backward sweep's instantiation for this plan
    (its layout included) that the card holds at once (the CUDA occupancy
    calculator times the SMs), asked once per plan and device."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    with torch.cuda.device(device):
        got = _build.load().gm_bwd_full_resident(route, int(mma), width, d, int(want_dx),
                                                 sliced)
    if got <= 0:
        raise RuntimeError(f"gm_bwd_full_resident failed: cudaError {-got}")
    return got


def bwd_full_finish(program, coef: torch.Tensor, part: torch.Tensor,
                    pdx: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dL/dcoef, dL/dx1 or None) from the full backward sweep's partials:
    ``part`` (one float64 row of sums per pass, split and row block) summed
    in a fixed order and turned into dL/dcoef by :func:`bwd_sym_coef` (a
    compiled leaf's S0, S1 rescaled); ``pdx`` (one fp32 partial of the
    x-gradient sums per pass and split) summed and scaled to the caller's
    coordinates by :func:`gram_bwd_dx_scale`."""
    d_coef = bwd_sym_coef(program, coef, part.sum(dim=0))
    if pdx is None:
        return d_coef, None
    return d_coef, gram_bwd_dx_scale(program, coef).to(pdx.dtype) * pdx.sum(dim=0)


def matvec_bwd_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: torch.Tensor,
                    v: torch.Tensor, ct: torch.Tensor, *, need_l2: bool,
                    want_dx: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The full backward sweep: for L = <ct, K(x1, x2) v>, (dL/dcoef,
    dL/dx1 or None) by the CUDA kernel (``csrc/gram_matvec_bwd.cuh``).
    Centred contiguous fp32 CUDA tensors x1c (n, d), x2c (m, d), v (m, r),
    ct (n, r), any d and r; trees up to MAX_BWD_INSTR instructions and
    MAX_BWD_COEF coefficients. Chosen here, before the launch: the route
    (:func:`sym_route`: one RBF or Matern leaf compiled on prescaled x), the
    passes and the product for G = ct V^T (:func:`bwd_full_passes`: register
    FMAs or 3xTF32 MMAs), the layout (x in registers for a compiled leaf at
    d <= 4, x2 staged at full width for the interpreter at d <= 8, else
    sliced: :func:`sliced_layout`), and the split of the x2 rows over blocks
    (:func:`bwd_full_split`, from the blocks the card holds at once). One
    call is two device launches (a staging pass that prescales x2 and
    stages V, then the sweep; three sliced, with x1's prescaled copy) and
    counts one. The kernel writes float64
    partials of the coefficient sums and fp32 partials of dx per pass and
    split, with no atomics; :func:`bwd_full_finish` sums them in a fixed
    order, so a rerun gives equal bits."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    _check_cuda_f32(coef=coef, x1=x1c, x2=x2c, v=v, ct=ct)
    n, d = x1c.shape
    m, r = v.shape
    if x2c.shape != (m, d) or ct.shape != (n, r):
        raise ValueError(
            f"shapes x1 {tuple(x1c.shape)}, x2 {tuple(x2c.shape)}, v {tuple(v.shape)}, "
            f"ct {tuple(ct.shape)} do not agree"
        )
    prog = _prog_tensor(program, MAX_BWD_INSTR, MAX_BWD_COEF, coef.numel(), x1c.device)
    lib = _build.load()
    route = sym_route(program)
    passes, width, mma = bwd_full_passes(r)
    sliced = int(sliced_layout(route, d, BWD_FULL_HELD_D))
    splits = bwd_full_split(n, m, _bwd_full_resident(route, mma, width, int(d), bool(want_dx),
                                                     sliced, x1c.device))
    m_pad = _round_up(m, BWD_FULL_STAGE)
    x1s = _slice_copy(_round_up(n, BWD_FULL_ROWS), d, x1c) if sliced else None
    x2s = torch.empty((m_pad, lib.gm_bwd_full_x_width(route, d, sliced)), dtype=torch.float32,
                      device=x1c.device)
    vs = torch.empty((passes, m_pad, width * (2 if mma else 1)), dtype=torch.float32,
                     device=x1c.device)
    part = torch.empty((passes * splits * -(-n // BWD_FULL_ROWS),
                        BWD_SYM_LEAF_SUMS if route else MAX_BWD_COEF),
                       dtype=torch.float64, device=x1c.device)
    pdx = torch.empty((passes * splits, n, d), dtype=torch.float32,
                      device=x1c.device) if want_dx else None
    with torch.cuda.device(x1c.device):
        err = lib.gm_matvec_bwd(
            x1c.data_ptr(), x2c.data_ptr(), v.data_ptr(), ct.data_ptr(), _ptr(x1s),
            x2s.data_ptr(), vs.data_ptr(), part.data_ptr(), _ptr(pdx), prog.data_ptr(),
            len(program), coef.data_ptr(), coef.numel(), route, int(mma), width, passes, splits,
            n, m, m_pad, d, r, int(need_l2), int(want_dx), sliced, _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_bwd launch failed: cudaError {err}")
    launch_counts["gram_matvec_bwd"] += 1
    return bwd_full_finish(program, coef, part, pdx)


def matvec_bwd_sym_cuda(program, coef: torch.Tensor, xc: torch.Tensor, v: torch.Tensor,
                        ct: torch.Tensor, *, need_l2: bool) -> torch.Tensor:
    """dL/dcoef for L = <ct, K(x, x) v> by the symmetric backward sweep over
    the upper-triangle tiles: the function of :func:`matvec_bwd_cuda` with
    x2 = x1 and no x-gradient. Centred contiguous fp32 CUDA tensors xc
    (n, d), v and ct (n, r), any d and r (passes of :func:`bwd_sym_passes`);
    trees up to MAX_BWD_INSTR instructions and MAX_BWD_COEF coefficients.
    The route (:func:`sym_route`), the pass width, the layout (x in
    registers for a compiled leaf at d <= 8, at full width for the
    interpreter at d <= 8, else sliced: :func:`sliced_layout`) and the work
    items (:func:`sym_schedule`) are chosen here, before the launch. The kernel
    writes one float64 partial per pass, work item and sum, with no
    atomics; they are summed here in a fixed order and turned into dL/dcoef
    by :func:`bwd_sym_coef`, so a rerun gives equal bits."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    _check_cuda_f32(coef=coef, x=xc, v=v, ct=ct)
    n, d = xc.shape
    r = v.shape[1]
    if v.shape[0] != n or ct.shape != (n, r):
        raise ValueError(
            f"shapes x {tuple(xc.shape)}, v {tuple(v.shape)}, ct {tuple(ct.shape)} do not agree"
        )
    prog = _prog_tensor(program, MAX_BWD_INSTR, MAX_BWD_COEF, coef.numel(), xc.device)
    lib = _build.load()
    passes, width = bwd_sym_passes(r)
    route = sym_route(program)
    sliced = int(sliced_layout(route, d, BWD_SYM_HELD_D))
    xs = _slice_copy(_round_up(n, SYM_TILE), d, xc) if sliced else None
    items = _sym_items_on_device(n, xc.device)
    n_sums = BWD_SYM_LEAF_SUMS if route else MAX_BWD_COEF
    part = torch.empty((passes * items.shape[0], n_sums), dtype=torch.float64,
                       device=xc.device)
    with torch.cuda.device(xc.device):
        err = lib.gm_matvec_bwd_sym(
            xc.data_ptr(), v.data_ptr(), ct.data_ptr(), part.data_ptr(), items.data_ptr(),
            items.shape[0], prog.data_ptr(), len(program), coef.data_ptr(), coef.numel(),
            route, width, n, d, r, int(need_l2), _ptr(xs), sliced, _stream(xc.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_bwd_sym launch failed: cudaError {err}")
    launch_counts["gram_matvec_bwd_sym"] += 1
    return bwd_sym_coef(program, coef, part.sum(dim=0))


# ---------------------------------------------------------------- autograd


class _GramSpec(NamedTuple):
    """What ``_GramFn`` needs besides its tensors."""

    kernel: _k.Kernel
    params: _k.Params  # the plain forward evaluates them
    program: tuple  # gram_program's postfix program
    white_idx: int
    need_l2: bool
    method: str  # the plain gram's distance method


def _gram_forward(spec: _GramSpec, coef, x1, x2) -> torch.Tensor:
    """``_GramFn``'s forward: the tile gram on a CUDA tensor (centred on
    mean(x1)), ``ops.gram`` on a CPU tensor."""
    if not x1.is_cuda:
        return gram_reference(spec.kernel, spec.params, x1, x2, method=spec.method)
    x1c, x2c = _centred(x1, x2)
    out = gram_cuda(spec.program, coef, x1c, x2c, white_idx=spec.white_idx,
                    need_l2=spec.need_l2)
    launch_counts["gram_ad"] += 1
    return out


def _centred(x1, x2):
    """x1 and x2 (or None) centred on mean(x1), contiguous."""
    center = torch.mean(x1, dim=0, keepdim=True)
    return ((x1 - center).contiguous(),
            None if x2 is None else (x2 - center).contiguous())


class _GramFn(torch.autograd.Function):
    """K(x1, x2) (``x2=None``: the same set), differentiable in the
    coefficient vector and the points: the JAX package's ``gram_ad``. The
    forward launches the tile gram on a CUDA tensor and is ``ops.gram`` on
    a CPU tensor. The backward gives d_coef, d_x1 and d_x2, each only if
    asked, from one launch of the tile gram's backward kernel on a CUDA
    tensor (:func:`gram_bwd_cuda`) and from its plain version on a CPU
    tensor (:func:`gram_vjp_reference`); autograd carries d_coef on to the
    params. It differentiates the tile gram's function, whose White leaves
    below the top-level sum are zero (the dispatcher sends such trees to
    the plain gram, and so does ``gram_ad`` on a CPU tensor). A same-set
    call has no x2 to differentiate."""

    @staticmethod
    def forward(ctx, coef, x1, x2, spec: _GramSpec):
        ctx.save_for_backward(coef, x1, x2)
        ctx.spec = spec
        return _gram_forward(spec, coef, x1, x2)

    @staticmethod
    def backward(ctx, ct):
        coef, x1, x2 = ctx.saved_tensors
        spec = ctx.spec
        want_coef, want_x1, want_x2 = ctx.needs_input_grad[:3]
        x1c, x2c = _centred(x1.detach(), None if x2 is None else x2.detach())
        vjp = gram_bwd_cuda if x1.is_cuda else gram_vjp_reference
        d_coef, d_x1, d_x2 = vjp(spec.program, coef, x1c, x2c, ct.contiguous(),
                                 white_idx=spec.white_idx, need_l2=spec.need_l2,
                                 want_dx1=want_x1, want_dx2=want_x2)
        return (d_coef if want_coef else None), d_x1, d_x2, None


def gram_ad(kernel: _k.Kernel, params: _k.Params, x1: torch.Tensor,
            x2: Optional[torch.Tensor] = None, *, method: str = "dot") -> torch.Tensor:
    """Differentiable dense gram through the tile gram (``_GramFn``): the
    JAX package's ``gram_ad``. Stationary kernels; on a CUDA tensor fp32
    only (it raises otherwise). The coefficient vector is built from the
    params here, so autograd reaches every hyperparameter through it.
    ``method`` is the plain gram's (the CPU forward); the tile gram and both
    backwards form the squared distance from direct differences on centred
    inputs."""
    if not _k.is_stationary(kernel):
        raise ValueError("gram_ad supports stationary kernels only")
    x1 = _k._dist._as_2d(x1)
    x2 = None if x2 is None else _k._dist._as_2d(x2)
    if nested_white(kernel) and not x1.is_cuda:
        # the plain gram places such a White leaf, the tile gram's function
        # (which both backwards differentiate) does not
        return gram_reference(kernel, params, x1, x2, method=method)
    program, coefs, white_idx = gram_program(kernel, params, x2 is None)
    coef = coef_vector(coefs, dtype=x1.dtype, device=x1.device)
    spec = _GramSpec(kernel, params, tuple(program), white_idx, _k.needs_l2(kernel), method)
    return _GramFn.apply(coef, x1, x2, spec)


class _Spec(NamedTuple):
    """What ``_GramMatvecFn`` needs besides its tensors."""

    kernel: _k.Kernel  # the white-free stationary tree
    params: _k.Params  # its params (the plain forward evaluates them)
    program: list  # encode(kernel, params)[0]
    need_l2: bool
    sym: bool  # the forward takes the symmetric sweep (x2 is x1)
    row_chunk: int  # rows per block of the plain forward


def _forward(spec: _Spec, coef, x1c, x2c, v) -> torch.Tensor:
    if not x1c.is_cuda:
        return gram_matvec_reference(spec.kernel, spec.params, x1c, x2c, v,
                                     row_chunk=spec.row_chunk)
    if spec.sym:
        return matvec_sym_cuda(spec.program, coef, x1c, v, need_l2=spec.need_l2)
    return matvec_full_cuda(spec.program, coef, x1c, x2c, v, need_l2=spec.need_l2)


def _vjp(spec: _Spec, coef, x1c, x2c, v, ct, want_dx: bool):
    """(dL/dcoef, dL/dx1 or None): the plain version on a CPU tensor; on a
    CUDA tensor the symmetric backward sweep for a same-set call whose
    forward took the symmetric sweep and that wants no x-gradient (a
    training step at r <= 64), else the full one (:func:`matvec_bwd_cuda`:
    a cross-set call, one that wants dx, or a same-set call past the
    symmetric rule, such as the 64-probe estimator's r = 65)."""
    if not x1c.is_cuda:
        return gram_matvec_vjp_reference(spec.program, coef, x1c, x2c, v, ct,
                                         need_l2=spec.need_l2, want_dx=want_dx)
    if spec.sym and not want_dx:
        return matvec_bwd_sym_cuda(spec.program, coef, x1c, v, ct, need_l2=spec.need_l2), None
    return matvec_bwd_cuda(spec.program, coef, x1c, x2c, v, ct, need_l2=spec.need_l2,
                           want_dx=want_dx)


class _GramMatvecFn(torch.autograd.Function):
    """K(x1, x2) @ v of a white-free kernel, differentiable in the
    coefficient vector, the centred points and v (the JAX package's
    ``_matvec_core`` with its custom VJP). Backward, each part only if asked:

    - d_coef and d_x1 from one backward sweep;
    - d_x2 from a second sweep with the roles swapped (x2, x1, ct, v), its
      d_coef discarded (<ct, K(x1, x2) v> = <v, K(x2, x1) ct>);
    - d_v = K(x2, x1) @ ct by the forward kernels.

    A same-set call passes one tensor as x1c and x2c, so its two
    x-gradients add. A training step needs only d_coef: one sweep, the
    symmetric one where the forward took the symmetric sweep (``_vjp``)."""

    @staticmethod
    def forward(ctx, coef, x1c, x2c, v, spec: _Spec):
        ctx.save_for_backward(coef, x1c, x2c, v)
        ctx.spec = spec
        return _forward(spec, coef, x1c, x2c, v)

    @staticmethod
    def backward(ctx, ct):
        coef, x1c, x2c, v = ctx.saved_tensors
        spec = ctx.spec
        want_coef, want_x1, want_x2, want_v = ctx.needs_input_grad[:4]
        ct = ct.contiguous()
        d_coef = d_x1 = d_x2 = d_v = None
        if want_v:
            d_v = _forward(spec, coef, x2c, x1c, ct)
        if want_coef or want_x1:
            d_coef, d_x1 = _vjp(spec, coef, x1c, x2c, v, ct, want_x1)
        if want_x2:
            _, d_x2 = _vjp(spec, coef, x2c, x1c, ct, v, True)
        return (d_coef if want_coef else None), d_x1, d_x2, d_v, None


# ---------------------------------------------------------------- dispatch


def use_matvec_kernel(kernel: _k.Kernel, x: torch.Tensor) -> bool:
    """The matrix-free rule: the CUDA sweeps for fp32 CUDA inputs and a
    stationary kernel (the JAX package's ``use_pallas``); the default
    ``use_kernel`` of every matrix-free path."""
    return x.is_cuda and x.dtype == torch.float32 and _k.is_stationary(kernel)


def use_gram_kernel(kernel: _k.Kernel, x: torch.Tensor) -> bool:
    """The dense-gram rule: :func:`use_matvec_kernel`, unless a White leaf
    sits below the top-level sum, which the tile gram cannot place."""
    return use_matvec_kernel(kernel, x) and not nested_white(kernel)


def gram(kernel: _k.Kernel, params: _k.Params, x1: torch.Tensor,
         x2: Optional[torch.Tensor] = None, *, method: str = "dot") -> torch.Tensor:
    """Dense K(x1, x2), every dense gram of the port: :func:`gram_ad` (the
    tile gram forward) where :func:`use_gram_kernel` holds, else the plain
    ``ops.gram``. The rule is decided before any launch; a tile gram that
    fails to build or launch raises."""
    x1 = torch.as_tensor(x1)
    if use_gram_kernel(kernel, x1):
        return gram_ad(kernel, params, x1, x2, method=method)
    return gram_reference(kernel, params, x1, x2, method=method)


def use_symmetric(n_rows: int, r: int) -> bool:
    """The JAX package's sweep rule (ops/pallas/kernel_ops.py:258-267), kept
    unchanged so both packages pick the same sweep: thin RHS, n >= 2048, and
    an accumulator of at most 48 MB at its 512-row tile padding. The 48 MB
    term is a TPU VMEM budget that has yet to be re-derived from H100
    measurements."""
    r_pad = max(8, _round_up(r, 8))
    n_pad = _round_up(n_rows, 512)
    return r_pad <= 64 and r_pad * n_pad * 4 <= (48 << 20) and n_rows >= 2048


def gram_matvec(
    kernel: _k.Kernel,
    params: _k.Params,
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    v: torch.Tensor,
    *,
    symmetric: Optional[bool] = None,
    row_chunk: int = 4096,
    dot_mode: str = "split3",
) -> torch.Tensor:
    """K(x1, x2) @ v without materialising K (matrix-free; powers CG).

    ``v``: (m,) or (m, r). ``x2=None`` means the same set, White's diagonal
    included. Differentiable in ``params``, ``x1``, ``x2`` and ``v``: the
    gradient of the kernel part goes through ``_GramMatvecFn`` (its backward
    is a CUDA backward sweep on the card), White's ``white * v`` term
    through ordinary autograd. The inputs are centred on a detached
    mean(x1), as the JAX package's ``lax.stop_gradient`` centre.

    ``dot_mode``, the JAX package's names and default: "split3" or
    "highest" (anything else raises ``ValueError``). The JAX callers pass
    "highest" below a CG tolerance of 1e-5, as the port's do, because the
    TPU's bf16 split product stops at about 1.5e-5. On the card every sweep
    computes the same product under both modes: the full sweep 3xTF32 on
    the tensor cores, within a few 1e-6 of float64 at n = 102400 (more
    precise than fp32 FMAs over the same sweep), the symmetric one fp32
    FMAs; the full backward sweep forms G = ct V^T in 3xTF32 past
    BWD_FULL_FMA[-1] columns (fp32's precision, as the JAX sweep's
    ``Precision.HIGHEST``), the symmetric one by fp32 FMAs. On the CPU the
    plain version runs under
    both. ``row_chunk`` bounds the plain forward's memory on the CPU.
    """
    with _profiling.span("gp.kernels.matvec"):
        if dot_mode not in DOT_MODES:
            raise ValueError(f"dot_mode must be one of {DOT_MODES}, got {dot_mode!r}")
        if not _k.is_stationary(kernel):
            raise ValueError("gram_matvec supports stationary kernels only")
        same = x2 is None
        x1 = _k._dist._as_2d(x1)
        vec_in = v.ndim == 1
        vv = v[:, None] if vec_in else v

        white_var = None
        if same:
            kernel, params, white_var = _k.split_white(kernel, params)
            if kernel is None:  # pure-White kernel: diagonal matvec
                out = white_var * vv
                return out[:, 0] if vec_in else out
        center = torch.mean(x1, dim=0, keepdim=True).detach()
        x1c = (x1 - center).contiguous()
        x2c = x1c if same else (_k._dist._as_2d(x2) - center).contiguous()
        sym = same and (symmetric if symmetric is not None
                        else use_symmetric(x1.shape[0], vv.shape[1]))
        program, coefs = encode(kernel, params)
        coef = coef_vector(coefs, dtype=x1.dtype, device=x1.device)
        spec = _Spec(kernel, params, program, _k.needs_l2(kernel), sym, row_chunk)
        out = _GramMatvecFn.apply(coef, x1c, x2c, vv.contiguous(), spec)
        if white_var is not None:
            out = out + white_var * vv
        return out[:, 0] if vec_in else out
