// The sliced-layout instantiations (any d; D = X_SLICED) of K4's full
// backward sweep for RBF, compiled beside gram_matvec_bwd.cu. The kernel
// and its design are in gram_matvec_bwd.cuh.

#include "gram_matvec_bwd.cuh"

BwdFullFn gm_bwd_full_pick_sliced_rbf(const BwdFullPlan& p) {
  return p.leaf == OP_RBF ? bf_pick_sliced<OP_RBF>(p) : nullptr;
}
