// The sliced-layout instantiations (any d; D = X_SLICED) of K2 for the
// interpreter and RBF, compiled beside gram_matvec.cu; the Materns' are in
// gram_matvec_full_sliced_matern.cu. The kernel and its design are in
// gram_matvec_full.cuh.

#include "gram_matvec_full.cuh"

cudaError_t gm_full_launch_sliced(const FullArgs& a, int leaf, int passes, cudaStream_t st) {
  switch (leaf) {
    case 0: return full_launch_d<0, X_SLICED>(a, passes, st);
    case OP_RBF: return full_launch_d<OP_RBF, X_SLICED>(a, passes, st);
    case OP_MATERN12:
    case OP_MATERN32:
    case OP_MATERN52: return gm_full_launch_sliced_matern(a, leaf, passes, st);
    default: return cudaErrorInvalidValue;
  }
}
