"""Matrix-free kernel matvec K(x1, x2) @ V on the GPU, with its plain version.

Torch counterpart of the forward half of
the JAX package's ``ops/pallas/kernel_ops.py:gram_matvec``. Two
hand-written CUDA kernels (``csrc/gram_matvec.cu``) do the work on a CUDA
tensor:

- :func:`matvec_full_cuda` (full sweep, replaces ``_matvec_fwd_impl``);
- :func:`matvec_sym_cuda` (same-set upper-triangle sweep, replaces
  ``_matvec_fwd_sym_impl``).

:func:`gram_matvec` keeps the JAX package's dispatch rule, so both packages
pick the same sweep for the same inputs. On a CPU tensor it runs
:func:`gram_matvec_reference`, the plain PyTorch version; on a CUDA tensor it
launches a kernel or raises. There is no fallback from one to the other.

The kernel tree reaches the GPU as a postfix program: each instruction is
(opcode, offset into a coefficient vector). Leaves push a kernel value
computed from the tile's squared distance ``sq`` and, where needed,
``l2 = sqrt(sq)``; SCALE multiplies the top of the stack by a coefficient;
ADD and MUL combine the top two. The coefficients are derived from the
params tensors on the device (``-0.5 / l^2`` and so on), so a new
hyperparameter value needs no new build. :func:`eval_program` interprets the
same program in torch; the tests hold it against ``ops.gram``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

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
# largest dynamic shared memory a block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

# launches of each kernel, counted where the wrapper launches it
launch_counts = {"gram_matvec_full": 0, "gram_matvec_sym": 0}


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
    already on ``device``)."""
    if not coefs:
        return torch.zeros(1, dtype=dtype, device=device)
    return torch.stack(
        [torch.as_tensor(c).to(device=device, dtype=dtype).reshape(()) for c in coefs]
    )


def eval_program(program, coef: torch.Tensor, sq: torch.Tensor,
                 l2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Torch interpreter of the postfix program (the CUDA tile evaluator's
    arithmetic, op for op). Used by the tests to check the encoding."""
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


# ------------------------------------------------------------ plain version


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


# ------------------------------------------------------------ CUDA wrappers


def _check_cuda_f32(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device_program(kernel, params, device):
    program, coefs = encode(kernel, params)
    if len(program) > MAX_INSTR or len(coefs) > MAX_COEF:
        raise ValueError("kernel tree too large for the CUDA matvec")
    if _stack_depth(program) > MAX_STACK:
        raise ValueError("kernel tree nested too deeply for the CUDA matvec")
    prog = torch.tensor(program, dtype=torch.int32).reshape(-1).to(device)
    coef = coef_vector(coefs, dtype=torch.float32, device=device)
    return prog, len(program), coef, len(coefs)


def _launch_args(kernel, params, x1, v, symmetric: bool):
    from gaussian_process_tpu_torch.ops.cuda import _build

    lib = _build.load()
    d = x1.shape[1]
    smem = lib.gm_smem_bytes(int(v.shape[1]), int(d), int(symmetric))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d = {d} needs {smem} bytes of shared memory per block")
    prog, n_instr, coef, n_coef = _device_program(kernel, params, x1.device)
    need_l2 = int(_k.needs_l2(kernel))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x1.device).cuda_stream)
    return lib, prog, n_instr, coef, n_coef, need_l2, stream


def matvec_full_cuda(kernel, params, x1c: torch.Tensor, x2c: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """K(x1, x2) @ v by the full-sweep CUDA kernel. Takes centred,
    contiguous fp32 CUDA tensors x1c (n, d), x2c (m, d), v (m, r) and a
    white-free stationary kernel; raises on anything else."""
    _check_cuda_f32(x1=x1c, x2=x2c, v=v)
    n, d = x1c.shape
    m, r = v.shape
    if x2c.shape != (m, d):
        raise ValueError(f"x2 shape {tuple(x2c.shape)} does not match v {tuple(v.shape)}")
    lib, prog, n_instr, coef, n_coef, need_l2, stream = _launch_args(
        kernel, params, x1c, v, False)
    out = torch.empty((n, r), dtype=torch.float32, device=x1c.device)
    with torch.cuda.device(x1c.device):
        err = lib.gm_matvec_full(
            x1c.data_ptr(), x2c.data_ptr(), v.data_ptr(), out.data_ptr(),
            prog.data_ptr(), n_instr, coef.data_ptr(), n_coef, n, m, d, r, need_l2,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_full launch failed: cudaError {err}")
    launch_counts["gram_matvec_full"] += 1
    return out


def matvec_sym_cuda(kernel, params, xc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K(x, x) @ v by the upper-triangle CUDA kernel (white-free kernel,
    centred contiguous fp32 CUDA tensors xc (n, d), v (n, r))."""
    _check_cuda_f32(x=xc, v=v)
    n, d = xc.shape
    if v.shape[0] != n:
        raise ValueError(f"v has {v.shape[0]} rows, x has {n}")
    r = v.shape[1]
    lib, prog, n_instr, coef, n_coef, need_l2, stream = _launch_args(
        kernel, params, xc, v, True)
    out = torch.zeros((n, r), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        err = lib.gm_matvec_sym(
            xc.data_ptr(), v.data_ptr(), out.data_ptr(), prog.data_ptr(), n_instr,
            coef.data_ptr(), n_coef, n, d, r, need_l2, stream,
        )
    if err != 0:
        raise RuntimeError(f"gm_matvec_sym launch failed: cudaError {err}")
    launch_counts["gram_matvec_sym"] += 1
    return out


# ---------------------------------------------------------------- dispatch


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
    included. The CUDA kernels form the output product with plain fp32
    FMAs, so the JAX package's ``dot_mode`` has no counterpart here.
    ``row_chunk`` bounds the plain version's memory on the CPU.
    """
    if not _k.is_stationary(kernel):
        raise ValueError("gram_matvec supports stationary kernels only")
    same = x2 is None
    x1 = _k._dist._as_2d(x1)
    vec_in = v.ndim == 1
    vv = v[:, None] if vec_in else v
    if not x1.is_cuda:
        out = gram_matvec_reference(kernel, params, x1, x2, vv, same=same,
                                    row_chunk=row_chunk)
        return out[:, 0] if vec_in else out

    white_var = None
    if same:
        kernel, params, white_var = _k.split_white(kernel, params)
        if kernel is None:  # pure-White kernel: diagonal matvec
            out = white_var * vv
            return out[:, 0] if vec_in else out
        x2 = x1
    x2 = _k._dist._as_2d(x2)
    # centre on mean(x1), as the TPU kernels' _build_common does
    center = torch.mean(x1, dim=0, keepdim=True)
    x1c = (x1 - center).contiguous()
    vc = vv.contiguous()
    sym = same and (symmetric if symmetric is not None
                    else use_symmetric(x1.shape[0], vv.shape[1]))
    if sym:
        out = matvec_sym_cuda(kernel, params, x1c, vc)
    else:
        x2c = x1c if same else (x2 - center).contiguous()
        out = matvec_full_cuda(kernel, params, x1c, x2c, vc)
    if white_var is not None:
        out = out + white_var * vv
    return out[:, 0] if vec_in else out
