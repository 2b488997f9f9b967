"""The dense kernel matrix K(x1, x2) and the matrix-free matvec
K(x1, x2) @ V on the GPU, differentiable, with their plain versions.

Torch counterpart of the JAX package's ``ops/pallas/kernel_ops.py``
(``gram``, ``gram_ad``, ``gram_matvec`` and its custom VJP). Four
hand-written CUDA kernels do the work on a CUDA tensor:

- :func:`gram_cuda` (the tile gram, ``csrc/gram.cu``, replaces ``gram``);
- :func:`matvec_full_cuda` (full sweep, ``csrc/gram_matvec.cu``, replaces
  ``_matvec_fwd_impl``);
- :func:`matvec_sym_cuda` (same-set upper-triangle sweep, same file,
  replaces ``_matvec_fwd_sym_impl``);
- :func:`matvec_bwd_cuda` (the backward sweep, ``csrc/gram_matvec_bwd.cu``,
  replaces ``_matvec_bwd_sweep``).

:func:`gram` is the port's one dense-gram dispatcher: fp32 CUDA inputs and
a stationary kernel take :func:`gram_ad` (``_GramFn``: the tile gram
forward, the plain gram's VJP backward, as the JAX ``gram_ad``), anything
else the plain ``ops.gram``. :func:`gram_matvec` keeps the JAX package's
sweep rule, so both packages pick the same sweep for the same inputs, and
runs through ``_GramMatvecFn``, whose backward gives the gradients in the
coefficient vector, x1, x2 and V. On a CPU tensor the Functions run the
plain versions (:func:`gram_reference`, :func:`gram_matvec_reference`,
:func:`gram_matvec_vjp_reference`); on a CUDA tensor they launch a kernel or
raise. There is no fallback from one to the other.

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

# opcodes: keep in sync with csrc/gram_matvec.cu
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
# the backward sweep keeps every instruction's value per entry: smaller limits
MAX_BWD_INSTR = 16
MAX_BWD_COEF = 16
BWD_ROWS = 64  # x1 rows per block of the backward sweep (its partials' count)
# the symmetric sweep's fixed point: each column's largest sum is scaled to
# at most 2^61, two bits below int64's range (csrc/gram_matvec.cu)
FIXED_POINT_BITS = 61
# largest dynamic shared memory a block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

# launches of each kernel, counted where the wrapper launches it: "gram"
# counts every launch of the tile gram, "gram_ad" those made by its
# differentiable wrapper, "chol_inv_panel" each call of the panel factor
# (ops/cuda/chol.py), whatever its count of device launches
launch_counts = {"gram": 0, "gram_ad": 0, "gram_matvec_full": 0, "gram_matvec_sym": 0,
                 "gram_matvec_bwd": 0, "chol_inv_panel": 0}


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
    zero (``eval_from_distances`` semantics: callers add the white diagonal).
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
            leaf(OP_ZERO)
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
    plain version of ``tree_grad`` in ``csrc/gram_matvec_bwd.cu``."""
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
    """Plain PyTorch version of the backward sweep: for L = <ct, K(x1, x2) v>
    returns (dL/dcoef, dL/dx1 or None), with the kernel's arithmetic (direct
    squared differences, hand-written leaf derivatives, the same rule at
    coincident points). Row blocks of ``row_chunk`` rows (None: about 2^24
    entries each) bound the memory."""
    n, d = x1c.shape
    m = x2c.shape[0]
    if row_chunk is None:
        row_chunk = max(1, (1 << 24) // m)
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


def _forward_args(program, coef, x, v, symmetric: bool):
    from gaussian_process_tpu_torch.ops.cuda import _build

    lib = _build.load()
    d = x.shape[1]
    smem = lib.gm_smem_bytes(int(v.shape[1]), int(d), int(symmetric))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d = {d} needs {smem} bytes of shared memory per block")
    prog = _prog_tensor(program, MAX_INSTR, MAX_COEF, coef.numel(), x.device)
    return lib, prog


def gram_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: Optional[torch.Tensor],
              *, white_idx: int, need_l2: bool) -> torch.Tensor:
    """K(x1, x2) (n, m) by the tile-gram CUDA kernel, for the postfix
    ``program`` over ``coef`` (:func:`gram_program`). Takes centred,
    contiguous fp32 CUDA tensors x1c (n, d) and x2c (m, d); ``x2c=None`` is
    the same set, where ``coef[white_idx]`` (if ``white_idx >= 0``) goes on
    the diagonal. Raises on anything else."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    same = x2c is None
    x2c = x1c if same else x2c
    _check_cuda_f32(coef=coef, x1=x1c, x2=x2c)
    n, d = x1c.shape
    m = x2c.shape[0]
    if x2c.shape[1] != d:
        raise ValueError(f"x1 has {d} columns, x2 {x2c.shape[1]}")
    if white_idx >= 0 and not same:
        raise ValueError("White's diagonal belongs to a same-set gram only")
    lib = _build.load()
    smem = lib.gm_gram_smem_bytes(int(d))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d = {d} needs {smem} bytes of shared memory per block")
    prog = _prog_tensor(program, MAX_INSTR, MAX_COEF, coef.numel(), x1c.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x1c.device)
    with torch.cuda.device(x1c.device):
        err = lib.gm_gram(
            x1c.data_ptr(), x2c.data_ptr(), out.data_ptr(), prog.data_ptr(), len(program),
            coef.data_ptr(), coef.numel(), int(white_idx), n, m, d, int(need_l2),
            _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_gram launch failed: cudaError {err}")
    launch_counts["gram"] += 1
    return out


def matvec_full_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: torch.Tensor,
                     v: torch.Tensor, *, need_l2: bool) -> torch.Tensor:
    """K(x1, x2) @ v by the full-sweep CUDA kernel, for the postfix
    ``program`` over the coefficient vector ``coef`` (:func:`encode`). Takes
    centred, contiguous fp32 CUDA tensors x1c (n, d), x2c (m, d), v (m, r);
    raises on anything else."""
    _check_cuda_f32(coef=coef, x1=x1c, x2=x2c, v=v)
    n, d = x1c.shape
    m, r = v.shape
    if x2c.shape != (m, d):
        raise ValueError(f"x2 shape {tuple(x2c.shape)} does not match v {tuple(v.shape)}")
    lib, prog = _forward_args(program, coef, x1c, v, False)
    out = torch.empty((n, r), dtype=torch.float32, device=x1c.device)
    with torch.cuda.device(x1c.device):
        err = lib.gm_matvec_full(
            x1c.data_ptr(), x2c.data_ptr(), v.data_ptr(), out.data_ptr(),
            prog.data_ptr(), len(program), coef.data_ptr(), coef.numel(), n, m, d, r,
            int(need_l2), _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_full launch failed: cudaError {err}")
    launch_counts["gram_matvec_full"] += 1
    return out


def sym_fixed_point_scales(program, coef: torch.Tensor,
                           v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The symmetric sweep's fixed-point scales (``csrc/gram_matvec.cu``):
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


def matvec_sym_cuda(program, coef: torch.Tensor, xc: torch.Tensor, v: torch.Tensor, *,
                    need_l2: bool) -> torch.Tensor:
    """K(x, x) @ v by the upper-triangle CUDA kernel (centred contiguous
    fp32 CUDA tensors xc (n, d), v (n, r); ``program`` and ``coef`` as in
    :func:`matvec_full_cuda`). The kernel sums in 64-bit fixed point
    (:func:`sym_fixed_point_scales`), so the same inputs give the same bits
    on every run. One call is two device launches (the sweep and its
    finishing pass) and counts one launch."""
    _check_cuda_f32(coef=coef, x=xc, v=v)
    n, d = xc.shape
    if v.shape[0] != n:
        raise ValueError(f"v has {v.shape[0]} rows, x has {n}")
    r = v.shape[1]
    lib, prog = _forward_args(program, coef, xc, v, True)
    scale, flag = sym_fixed_point_scales(program, coef, v)
    acc = torch.zeros((n, r), dtype=torch.int64, device=xc.device)
    out = torch.empty((n, r), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        err = lib.gm_matvec_sym(
            xc.data_ptr(), v.data_ptr(), out.data_ptr(), acc.data_ptr(), flag.data_ptr(),
            scale.data_ptr(), prog.data_ptr(), len(program), coef.data_ptr(), coef.numel(),
            n, d, r, int(need_l2), _stream(xc.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_sym launch failed: cudaError {err}")
    launch_counts["gram_matvec_sym"] += 1
    return out


def matvec_bwd_cuda(program, coef: torch.Tensor, x1c: torch.Tensor, x2c: torch.Tensor,
                    v: torch.Tensor, ct: torch.Tensor, *, need_l2: bool,
                    want_dx: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward sweep: for L = <ct, K(x1, x2) v>, (dL/dcoef, dL/dx1 or
    None) by the CUDA kernel. Centred contiguous fp32 CUDA tensors x1c
    (n, d), x2c (m, d), v (m, r), ct (n, r); trees up to MAX_BWD_INSTR
    instructions and MAX_BWD_COEF coefficients. The kernel writes one
    float64 partial of dL/dcoef per 64-row block; they are summed here in
    float64."""
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
    smem = lib.gm_bwd_smem_bytes(int(d))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d = {d} needs {smem} bytes of shared memory per block")
    n_coef = coef.numel()
    part = torch.empty((-(-n // BWD_ROWS), n_coef), dtype=torch.float64, device=x1c.device)
    dx = torch.empty((n, d), dtype=torch.float32, device=x1c.device) if want_dx else None
    with torch.cuda.device(x1c.device):
        err = lib.gm_matvec_bwd(
            x1c.data_ptr(), x2c.data_ptr(), v.data_ptr(), ct.data_ptr(), part.data_ptr(),
            dx.data_ptr() if want_dx else None, prog.data_ptr(), len(program),
            coef.data_ptr(), n_coef, n, m, d, r, int(need_l2), int(want_dx),
            _stream(x1c.device),
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_bwd launch failed: cudaError {err}")
    launch_counts["gram_matvec_bwd"] += 1
    return part.sum(dim=0).to(coef.dtype), dx


# ---------------------------------------------------------------- autograd


class _GramSpec(NamedTuple):
    """What ``_GramFn`` needs besides its tensors."""

    kernel: _k.Kernel
    structure: _k.Params  # the params tree the leaves are unflattened into
    method: str  # the plain gram's distance method


def _gram_forward(spec: _GramSpec, params, x1, x2) -> torch.Tensor:
    """``_GramFn``'s forward: the tile gram on a CUDA tensor (centred on
    mean(x1)), ``ops.gram`` on a CPU tensor."""
    if not x1.is_cuda:
        return gram_reference(spec.kernel, params, x1, x2, method=spec.method)
    program, coefs, white_idx = gram_program(spec.kernel, params, x2 is None)
    coef = coef_vector(coefs, dtype=torch.float32, device=x1.device)
    center = torch.mean(x1, dim=0, keepdim=True)
    x1c = (x1 - center).contiguous()
    x2c = None if x2 is None else (x2 - center).contiguous()
    out = gram_cuda(program, coef, x1c, x2c, white_idx=white_idx,
                    need_l2=_k.needs_l2(spec.kernel))
    launch_counts["gram_ad"] += 1
    return out


class _GramFn(torch.autograd.Function):
    """K(x1, x2) (``x2=None``: the same set), differentiable in x1, x2 and
    the params leaves: the JAX package's ``gram_ad``. The forward launches
    the tile gram on a CUDA tensor and is ``ops.gram`` on a CPU tensor; the
    backward is the VJP of the plain ``ops.gram`` expression, recomputed
    under ``torch.enable_grad()``, as the JAX ``gram_ad``'s backward is
    ``jax.vjp`` of the XLA gram. It runs only when something is
    differentiated; a same-set call has no x2 to differentiate."""

    @staticmethod
    def forward(ctx, spec: _GramSpec, x1, x2, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x1, x2, *leaves)
        return _gram_forward(spec, _k.tree_unflatten(spec.structure, leaves), x1, x2)

    @staticmethod
    def backward(ctx, ct):
        spec = ctx.spec
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(saved, want)]
            K = gram_reference(spec.kernel, _k.tree_unflatten(spec.structure, inputs[2:]),
                               inputs[0], inputs[1], method=spec.method)
            wanted = [t for t, w in zip(inputs, want) if w]
            grads = iter(torch.autograd.grad(K, wanted, ct, allow_unused=True))
        out = []
        for t, w in zip(inputs, want):
            g = next(grads) if w else None
            out.append(torch.zeros_like(t) if w and g is None else g)
        return (None, *out)


def gram_ad(kernel: _k.Kernel, params: _k.Params, x1: torch.Tensor,
            x2: Optional[torch.Tensor] = None, *, method: str = "dot") -> torch.Tensor:
    """Differentiable dense gram through the tile gram (``_GramFn``): the
    JAX package's ``gram_ad``. Stationary kernels; on a CUDA tensor fp32
    only (it raises otherwise). ``method`` is the plain gram's (the CPU
    forward and every backward); the tile gram forms the squared distance
    from direct differences on centred inputs."""
    if not _k.is_stationary(kernel):
        raise ValueError("gram_ad supports stationary kernels only")
    x1 = _k._dist._as_2d(x1)
    x2 = None if x2 is None else _k._dist._as_2d(x2)
    structure = params
    leaves = [leaf if isinstance(leaf, torch.Tensor)
              else torch.tensor(leaf, dtype=torch.float64, device=x1.device)
              for leaf in _k.tree_leaves(params)]
    return _GramFn.apply(_GramSpec(kernel, structure, method), x1, x2, *leaves)


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
    if not x1c.is_cuda:
        return gram_matvec_vjp_reference(spec.program, coef, x1c, x2c, v, ct,
                                         need_l2=spec.need_l2, want_dx=want_dx)
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
    x-gradients add. A training step needs only d_coef: one sweep."""

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
) -> torch.Tensor:
    """K(x1, x2) @ v without materialising K (matrix-free; powers CG).

    ``v``: (m,) or (m, r). ``x2=None`` means the same set, White's diagonal
    included. Differentiable in ``params``, ``x1``, ``x2`` and ``v``: the
    gradient of the kernel part goes through ``_GramMatvecFn`` (its backward
    is the CUDA backward sweep on the card), White's ``white * v`` term
    through ordinary autograd. The inputs are centred on a detached
    mean(x1), as the JAX package's ``lax.stop_gradient`` centre. The CUDA
    kernels form the output product with plain fp32 FMAs, so the JAX
    package's ``dot_mode`` has no counterpart here. ``row_chunk`` bounds the
    plain forward's memory on the CPU.
    """
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
