// K2's Matern 3/2 and 5/2 instantiations at x width D = 8, compiled beside
// gram_matvec.cu (gram_matvec_full_d8.cu dispatches to them). The kernel
// and its design are in gram_matvec_full.cuh.

#include "gram_matvec_full.cuh"

cudaError_t gm_full_launch_d8_matern(const FullArgs& a, int leaf, int passes,
                                     cudaStream_t st) {
  switch (leaf) {
    case OP_MATERN32: return full_launch_d<OP_MATERN32, 8>(a, passes, st);
    case OP_MATERN52: return full_launch_d<OP_MATERN52, 8>(a, passes, st);
    default: return cudaErrorInvalidValue;
  }
}
