// K4's symmetric backward sweep: its launcher and its interpreted and RBF
// instantiations. The kernel and its design are in gram_matvec_bwd_sym.cuh.

#include "gram_matvec_bwd_sym.cuh"

namespace {

// x's width in registers for a compiled leaf: d padded to 4 or 8 (0 past
// d = 8: no such instantiation).
int bs_x_width(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : 0; }

}  // namespace

extern "C" {

// For L = <ct, K(x, x) v>: part ((r + R - 1) / R passes x n_items x sums,
// float64) receives one partial per pass, work item and sum (the caller
// sums them): S0 and S1 of the header for a compiled leaf (leaf = its
// opcode, RBF or a Matern), dL/dcoef_k for k < MAX_BWD_COEF for the postfix
// interpreter (leaf = 0; rows past n_coef are zero). items: n_items work
// items (ti, j0, j1) that cover every upper tile once
// (kernel_ops.sym_schedule). R: the columns of a pass (kernel_ops.
// bwd_sym_passes). x (n x d), v and ct (n x r): contiguous fp32 on the
// device. sliced: 1 for the sliced layout (any d), with xs scratch from the
// caller (n rounded up to 64 rows x d rounded up to 32 floats) and one
// launch first for x's prescaled copy; 0 for x at full width (a compiled
// leaf at d <= 8, the interpreter), xs null.
// Returns cudaGetLastError() after the launch.
int gm_matvec_bwd_sym(const float* x, const float* v, const float* ct, double* part,
                      const int* items, int n_items, const int* prog, int n_instr,
                      const float* coef, int n_coef, int leaf, int R, int n, int d, int r,
                      int need_l2, float* xs, int sliced, void* stream) {
  if (n_instr < 1 || n_instr > MAX_BWD_INSTR || n_coef < 1 || n_coef > MAX_BWD_COEF ||
      n < 1 || d < 1 || r < 1 || n_items < 1 || (leaf != 0 && n_instr != 1) ||
      (sliced != 0) != (xs != nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdSymArgs a{x, v, ct, part, items, prog, n_instr, coef, n_coef, n, d, r, need_l2,
                     xs, slice_width(d)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sliced) {
    const cudaError_t err =
        prescale_rows(x, prog, coef, leaf, xs, n, (n + TILE - 1) / TILE * TILE, d, st);
    if (err != cudaSuccess) return (int)err;
    return (int)gm_bwd_sym_launch_sliced(a, leaf, R, n_items, st);
  }
  switch (leaf) {
    case 0: return (int)bs_launch_d<0, 0>(a, R, n_items, st);
    case OP_RBF: return (int)bs_launch_leaf<OP_RBF>(a, R, bs_x_width(d), n_items, st);
    case OP_MATERN12:
    case OP_MATERN32:
    case OP_MATERN52:
      return (int)gm_bwd_sym_launch_matern(a, leaf, R, bs_x_width(d), n_items, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
