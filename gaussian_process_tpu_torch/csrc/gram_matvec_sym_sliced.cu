// The sliced-layout instantiations (any d; D = X_SLICED) of K3, every
// route, compiled beside gram_matvec_sym.cu. The kernel and its design are
// in gram_matvec_sym.cuh.

#include "gram_matvec_sym.cuh"

cudaError_t gm_sym_launch_sliced(const SymArgs& a, int leaf, int R, int n_items,
                                 cudaStream_t st) {
  switch (leaf) {
    case 0: return sym_launch_d<0, X_SLICED>(a, R, n_items, st);
    case OP_RBF: return sym_launch_d<OP_RBF, X_SLICED>(a, R, n_items, st);
    case OP_MATERN12: return sym_launch_d<OP_MATERN12, X_SLICED>(a, R, n_items, st);
    case OP_MATERN32: return sym_launch_d<OP_MATERN32, X_SLICED>(a, R, n_items, st);
    case OP_MATERN52: return sym_launch_d<OP_MATERN52, X_SLICED>(a, R, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}
