// K2's compiled leaves at x width D = 8 (5 <= d <= 8), compiled beside
// gram_matvec.cu: RBF and Matern 1/2 here, Matern 3/2 and 5/2 in
// gram_matvec_full_d8_matern.cu, twenty instantiations a source. The kernel
// and its design are in gram_matvec_full.cuh.

#include "gram_matvec_full.cuh"

cudaError_t gm_full_launch_d8(const FullArgs& a, int leaf, int passes, cudaStream_t st) {
  switch (leaf) {
    case OP_RBF: return full_launch_d<OP_RBF, 8>(a, passes, st);
    case OP_MATERN12: return full_launch_d<OP_MATERN12, 8>(a, passes, st);
    case OP_MATERN32:
    case OP_MATERN52: return gm_full_launch_d8_matern(a, leaf, passes, st);
    default: return cudaErrorInvalidValue;
  }
}
