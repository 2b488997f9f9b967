// The sliced-layout instantiations (any d; D = X_SLICED) of K2 for the
// Materns (1/2, 3/2, 5/2), compiled beside gram_matvec.cu. The kernel and
// its design are in gram_matvec_full.cuh.

#include "gram_matvec_full.cuh"

cudaError_t gm_full_launch_sliced_matern(const FullArgs& a, int leaf, int passes,
                                         cudaStream_t st) {
  switch (leaf) {
    case OP_MATERN12: return full_launch_d<OP_MATERN12, X_SLICED>(a, passes, st);
    case OP_MATERN32: return full_launch_d<OP_MATERN32, X_SLICED>(a, passes, st);
    case OP_MATERN52: return full_launch_d<OP_MATERN52, X_SLICED>(a, passes, st);
    default: return cudaErrorInvalidValue;
  }
}
