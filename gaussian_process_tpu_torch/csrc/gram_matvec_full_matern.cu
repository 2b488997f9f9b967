// K2's Matern instantiations (1/2, 3/2, 5/2), compiled beside
// gram_matvec.cu. The kernel and its design are in
// gram_matvec_full.cuh.

#include "gram_matvec_full.cuh"

cudaError_t gm_full_launch_matern(const FullArgs& a, int leaf, int passes, int D,
                                  cudaStream_t st) {
  switch (leaf) {
    case OP_MATERN12: return full_launch_leaf<OP_MATERN12>(a, passes, D, st);
    case OP_MATERN32: return full_launch_leaf<OP_MATERN32>(a, passes, D, st);
    case OP_MATERN52: return full_launch_leaf<OP_MATERN52>(a, passes, D, st);
    default: return cudaErrorInvalidValue;
  }
}
