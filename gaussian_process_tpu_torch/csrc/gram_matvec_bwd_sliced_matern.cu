// The sliced-layout instantiations (any d; D = X_SLICED) of K4's full
// backward sweep for the Materns (1/2, 3/2, 5/2), compiled beside
// gram_matvec_bwd.cu. The kernel and its design are in gram_matvec_bwd.cuh.

#include "gram_matvec_bwd.cuh"

BwdFullFn gm_bwd_full_pick_sliced_matern(const BwdFullPlan& p) {
  switch (p.leaf) {
    case OP_MATERN12: return bf_pick_sliced<OP_MATERN12>(p);
    case OP_MATERN32: return bf_pick_sliced<OP_MATERN32>(p);
    case OP_MATERN52: return bf_pick_sliced<OP_MATERN52>(p);
    default: return nullptr;
  }
}
