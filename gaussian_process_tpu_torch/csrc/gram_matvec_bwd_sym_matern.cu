// The Matern instantiations (1/2, 3/2, 5/2) of K4's symmetric backward
// sweep, compiled beside gram_matvec_bwd_sym.cu. The kernel and its design
// are in gram_matvec_bwd_sym.cuh.

#include "gram_matvec_bwd_sym.cuh"

cudaError_t gm_bwd_sym_launch_matern(const BwdSymArgs& a, int leaf, int R, int D, int n_items,
                                     cudaStream_t st) {
  switch (leaf) {
    case OP_MATERN12: return bs_launch_leaf<OP_MATERN12>(a, R, D, n_items, st);
    case OP_MATERN32: return bs_launch_leaf<OP_MATERN32>(a, R, D, n_items, st);
    case OP_MATERN52: return bs_launch_leaf<OP_MATERN52>(a, R, D, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}
