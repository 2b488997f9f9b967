// K3's Matern instantiations (1/2, 3/2, 5/2), compiled beside
// gram_matvec_sym.cu. The kernel and its design are in gram_matvec_sym.cuh.

#include "gram_matvec_sym.cuh"

cudaError_t gm_sym_launch_matern(const SymArgs& a, int leaf, int R, int D, int n_items,
                                 cudaStream_t st) {
  switch (leaf) {
    case OP_MATERN12: return sym_launch_leaf<OP_MATERN12>(a, R, D, n_items, st);
    case OP_MATERN32: return sym_launch_leaf<OP_MATERN32>(a, R, D, n_items, st);
    case OP_MATERN52: return sym_launch_leaf<OP_MATERN52>(a, R, D, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}
