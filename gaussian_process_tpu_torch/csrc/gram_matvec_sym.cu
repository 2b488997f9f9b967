// K3's launcher, its interpreted and RBF instantiations and its finishing
// pass. The kernel and its design are in gram_matvec_sym.cuh.

#include "gram_matvec_sym.cuh"

namespace {

// out = sum / 2^e_col, or NaN in a flagged column; rows by blockIdx.x and
// threadIdx.y, columns by threadIdx.x.
__global__ void __launch_bounds__(THREADS)
    sym_finish_kernel(const long long* __restrict__ sum, const unsigned int* __restrict__ flag,
                      const double* __restrict__ scale, float* __restrict__ out, int n, int r) {
  for (int row = blockIdx.x * blockDim.y + threadIdx.y; row < n; row += gridDim.x * blockDim.y)
    for (int col = threadIdx.x; col < r; col += blockDim.x) {
      const size_t idx = (size_t)row * r + col;
      out[idx] = flag[col] ? __int_as_float(0x7fc00000) : (float)((double)sum[idx] / scale[col]);
    }
}

// The x width of a plan: X_SLICED for the sliced layout; else d padded to
// 2, 4 or 8 in registers for a compiled leaf (0 past d = 8: no such
// instantiation), 0 (a loop over d) for the interpreter.
int sym_x_width(int leaf, int d, int sliced) {
  if (sliced) return X_SLICED;
  if (leaf == 0) return 0;
  return d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 0;
}

}  // namespace

extern "C" {

// out (n x r) = K(x, x) @ v from the upper-triangle tiles, bitwise the same
// on every run. items: n_items work items (ti, j0, j1) that cover every
// upper tile once (kernel_ops.sym_schedule). leaf: 0 for the postfix
// interpreter, else the opcode of the tree's one leaf (RBF or a Matern).
// R: the columns of a pass, 1, 2, 4, 8 or 16 (kernel_ops.sym_columns).
// Both are chosen by the wrapper, with the layout: sliced = 1 for the
// sliced layout (any d), with xs scratch from the caller (n rounded up to 64
// rows x d rounded up to 32 floats) and one launch first for x's prescaled
// copy; 0 for x at full width (a compiled leaf at d <= 8, the interpreter),
// xs null. Scratch from the caller: sum (n x r int64, zeroed), flag (r
// int32, 1 where a column's bound is not finite, else 0) and scale (r
// doubles, 2^e_c). Then the sweep into sum and the finishing pass into
// out. Returns the first launch error, else cudaGetLastError().
int gm_matvec_sym(const float* x, const float* v, float* out, void* sum, unsigned int* flag,
                  const double* scale, const int* items, int n_items, const int* prog,
                  int n_instr, const float* coef, int n_coef, int leaf, int R, int n, int d,
                  int r, int need_l2, float* xs, int sliced, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || d < 1 || r < 1 || n_items < 1 ||
      (leaf != 0 && n_instr != 1) || (sliced != 0) != (xs != nullptr))
    return (int)cudaErrorInvalidValue;
  const SymArgs a{x, v, static_cast<unsigned long long*>(sum), flag, scale, items, prog,
                  n_instr, coef, n_coef, n, d, r, need_l2, xs, slice_width(d)};
  const int D = sym_x_width(leaf, d, sliced);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sliced) {
    err = prescale_rows(x, prog, coef, leaf, xs, n, (n + TILE - 1) / TILE * TILE, d, st);
    if (err == cudaSuccess) err = gm_sym_launch_sliced(a, leaf, R, n_items, st);
  } else {
    switch (leaf) {
      case 0:
        err = sym_launch_d<0, 0>(a, R, n_items, st);
        break;
      case OP_RBF:
        err = sym_launch_leaf<OP_RBF>(a, R, D, n_items, st);
        break;
      case OP_MATERN12:
      case OP_MATERN32:
      case OP_MATERN52:
        err = gm_sym_launch_matern(a, leaf, R, D, n_items, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + 7) / 8;
  sym_finish_kernel<<<blocks < 4096 ? blocks : 4096, dim3(32, 8), 0, st>>>(
      static_cast<const long long*>(sum), flag, scale, out, n, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
