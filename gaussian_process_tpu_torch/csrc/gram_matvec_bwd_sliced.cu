// The sliced-layout instantiations (any d; D = X_SLICED) of K4's full
// backward sweep for the interpreter, compiled beside gram_matvec_bwd.cu;
// RBF's are in gram_matvec_bwd_sliced_rbf.cu, the Materns' in
// gram_matvec_bwd_sliced_matern.cu. The kernel and its design are in
// gram_matvec_bwd.cuh.

#include "gram_matvec_bwd.cuh"

BwdFullFn gm_bwd_full_pick_sliced(const BwdFullPlan& p) {
  return p.leaf == 0 ? bf_pick_sliced<0>(p) : nullptr;
}
