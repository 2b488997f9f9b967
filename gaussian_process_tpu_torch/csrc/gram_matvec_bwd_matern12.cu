// The Matern 1/2 instantiations of K4's full backward sweep, compiled beside
// gram_matvec_bwd.cu. The kernel and its design are in gram_matvec_bwd.cuh.

#include "gram_matvec_bwd.cuh"

BwdFullFn gm_bwd_full_pick_matern12(const BwdFullPlan& p) { return bf_pick<OP_MATERN12>(p); }
