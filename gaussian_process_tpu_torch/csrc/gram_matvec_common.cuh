// Shared by the tile gram (K1, gram.cu) and its backward (K5, gram_bwd.cu),
// the forward sweeps (K2, gram_matvec_full.cuh; K3, gram_matvec_sym.cuh) and
// the backward sweeps (K4: gram_matvec_bwd.cuh, the full sweep, and
// gram_matvec_bwd_sym.cuh, the symmetric one): the postfix program's
// opcodes, the per-entry leaf arithmetic and its hand-written derivatives,
// the reverse pass through a program, the compiled leaves and their
// backward terms, the tile loaders, and the copies and 3xTF32 MMA pieces of
// the tensor-core sweeps (K2, K4's full one). Keeping one copy means the backward
// differentiates exactly the function that the forward evaluates.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Opcodes: keep in sync with gaussian_process_tpu_torch/ops/cuda/kernel_ops.py.
constexpr int OP_ZERO = 0;
constexpr int OP_RBF = 1;               // c0 exp(c1 sq)
constexpr int OP_MATERN12 = 2;          // c0 exp(-c1 l2)
constexpr int OP_MATERN32 = 3;          // s = c1 l2: c0 (1 + s) exp(-s)
constexpr int OP_MATERN52 = 4;          // s = c1 l2: c0 (1 + s + s^2/3) exp(-s)
constexpr int OP_PERIODIC = 5;          // s = sin(c0 l2): exp(c1 s^2)
constexpr int OP_DECAYED_PERIODIC = 6;  // s = sin(c2 l2): c0 exp(c1 sq + c3 s^2)
constexpr int OP_RQ = 7;                // c0 exp(c2 log1p(c1 sq))
constexpr int OP_SCALE = 8;             // top *= c0
constexpr int OP_ADD = 9;
constexpr int OP_MUL = 10;

constexpr int MAX_INSTR = 64;
constexpr int MAX_COEF = 256;
constexpr int MAX_STACK = 8;
constexpr int TILE = 64;          // x1 rows and x2 rows per tile
constexpr int THREADS = 256;      // threads per block
constexpr int KS_LD = TILE + 1;   // padded row of a 64 x 64 tile in shared memory

__device__ __forceinline__ float eval_leaf(int op, const float* c, float sq, float l2) {
  switch (op) {
    case OP_RBF:
      return c[0] * expf(c[1] * sq);
    case OP_MATERN12:
      return c[0] * expf(-c[1] * l2);
    case OP_MATERN32: {
      float s = c[1] * l2;
      return c[0] * (1.0f + s) * expf(-s);
    }
    case OP_MATERN52: {
      float s = c[1] * l2;
      return c[0] * (1.0f + s + s * s * (1.0f / 3.0f)) * expf(-s);
    }
    case OP_PERIODIC: {
      float s = sinf(c[0] * l2);
      return expf(c[1] * s * s);
    }
    case OP_DECAYED_PERIODIC: {
      float s = sinf(c[2] * l2);
      return c[0] * expf(c[1] * sq + c[3] * s * s);
    }
    case OP_RQ:
      return c[0] * expf(c[2] * log1pf(c[1] * sq));
    default:
      return 0.0f;
  }
}

// Number of coefficients a leaf reads.
__device__ __forceinline__ int leaf_coefs(int op) {
  switch (op) {
    case OP_DECAYED_PERIODIC:
      return 4;
    case OP_RQ:
      return 3;
    case OP_ZERO:
      return 0;
    default:
      return 2;
  }
}

// A leaf's value k and its derivatives: dc[j] = dk/dc_j (zero past the
// leaf's coefficients) and dsq = dk/dsq, with l2 = sqrt(sq) folded in.
//
// For the families that read l2, dk/dsq = (dk/dl2) / (2 l2), which diverges
// where two points coincide (sq = 0). The derivative of the kernel with
// respect to a point is dk/dsq * 2 (a - b), and a - b = 0 there, so this
// function returns dsq = 0 at sq = 0: coincident pairs add nothing to the
// x-gradient (the true derivative for every smooth family, and the zero
// subgradient at Matern 1/2's kink). The coefficient derivatives never
// carry the 1/l2 factor, so they stay finite everywhere. Matern 3/2 and
// 5/2 have a dk/dl2 proportional to l2 and use the cancelled closed form.
__device__ __forceinline__ void leaf_grad(int op, const float* c, float sq, float l2,
                                          float& k, float (&dc)[4], float& dsq) {
  dc[0] = dc[1] = dc[2] = dc[3] = 0.0f;
  const float inv_2l2 = l2 > 0.0f ? 0.5f / l2 : 0.0f;
  switch (op) {
    case OP_RBF: {
      const float e = expf(c[1] * sq);
      k = c[0] * e;
      dc[0] = e;
      dc[1] = k * sq;
      dsq = k * c[1];
      break;
    }
    case OP_MATERN12: {
      const float e = expf(-c[1] * l2);
      k = c[0] * e;
      dc[0] = e;
      dc[1] = -k * l2;
      dsq = -k * c[1] * inv_2l2;
      break;
    }
    case OP_MATERN32: {
      const float s = c[1] * l2, e = expf(-s);
      k = c[0] * (1.0f + s) * e;
      dc[0] = (1.0f + s) * e;
      const float ce = c[0] * e;
      dc[1] = -ce * s * l2;             // dk/ds = -c0 s e, ds/dc1 = l2
      dsq = -0.5f * ce * c[1] * c[1];   // dk/ds * c1 / (2 l2)
      break;
    }
    case OP_MATERN52: {
      const float s = c[1] * l2, e = expf(-s);
      const float p = 1.0f + s + s * s * (1.0f / 3.0f);
      k = c[0] * p * e;
      dc[0] = p * e;
      const float ce = c[0] * e;
      dc[1] = -ce * s * (1.0f + s) * (1.0f / 3.0f) * l2;         // dk/ds = -c0 e s (1 + s) / 3
      dsq = -ce * c[1] * c[1] * (1.0f + s) * (1.0f / 6.0f);     // dk/ds * c1 / (2 l2)
      break;
    }
    case OP_PERIODIC: {
      float sn, cs;
      sincosf(c[0] * l2, &sn, &cs);
      k = expf(c[1] * sn * sn);
      const float dk_dsarg = k * c[1] * 2.0f * sn * cs;  // dk / d(c0 l2)
      dc[0] = dk_dsarg * l2;
      dc[1] = k * sn * sn;
      dsq = dk_dsarg * c[0] * inv_2l2;
      break;
    }
    case OP_DECAYED_PERIODIC: {
      float sn, cs;
      sincosf(c[2] * l2, &sn, &cs);
      const float e = expf(c[1] * sq + c[3] * sn * sn);
      k = c[0] * e;
      dc[0] = e;
      dc[1] = k * sq;
      dc[3] = k * sn * sn;
      const float dk_dsarg = k * c[3] * 2.0f * sn * cs;  // dk / d(c2 l2)
      dc[2] = dk_dsarg * l2;
      dsq = k * c[1] + dk_dsarg * c[2] * inv_2l2;
      break;
    }
    case OP_RQ: {
      const float u = c[1] * sq;
      const float lg = log1pf(u);
      const float e = expf(c[2] * lg);
      k = c[0] * e;
      dc[0] = e;
      const float kc2_1pu = k * c[2] / (1.0f + u);
      dc[1] = kc2_1pu * sq;
      dc[2] = k * lg;
      dsq = kc2_1pu * c[1];
      break;
    }
    default:
      k = 0.0f;
      dsq = 0.0f;
      break;
  }
}

// ------------------------------------------------------- the reverse pass
//
// Shared by the backward sweeps (gram_matvec_bwd.cuh, the full sweep;
// gram_matvec_bwd_sym.cuh, the symmetric one) and the tile gram's backward
// (gram_bwd.cu). tree_grad keeps every instruction's forward value per
// entry, in arrays of NI instructions and NC coefficients: the sweeps take
// trees of at most MAX_BWD_INSTR and MAX_BWD_COEF, the tile gram's backward
// also the forward's MAX_INSTR and MAX_COEF (arrays in local memory).

constexpr int MAX_BWD_INSTR = 16;
constexpr int MAX_BWD_COEF = 16;
constexpr int LEAF_COEF = 4;  // coefficients of the largest leaf

// The operand instructions of each ADD / MUL (two) and SCALE (one) of the
// program, into kid (2 n_instr ints), by simulating its stack.
__device__ __forceinline__ void program_kids(const int* prog, int n_instr, int* kid) {
  int st[MAX_STACK];
  int sp = 0;
  for (int k = 0; k < n_instr; ++k) {
    const int op = prog[2 * k];
    if (op == OP_ADD || op == OP_MUL) {
      kid[2 * k] = st[sp - 2];
      kid[2 * k + 1] = st[sp - 1];
      st[sp - 2] = k;
      --sp;
    } else if (op == OP_SCALE) {
      kid[2 * k] = st[sp - 1];
      st[sp - 1] = k;
    } else {
      st[sp++] = k;
    }
  }
}

// Reverse pass through the whole program for one entry with root adjoint g
// (there is no in-kernel jax.vjp): the forward value of every instruction
// is kept, then ADD passes the adjoint through, MUL multiplies it by the
// other operand, SCALE multiplies it by its coefficient and adds value x
// adjoint to that coefficient's gradient, and each leaf adds to its own
// coefficients (leaf_grad). Adds g dk/dcoef into tacc and returns
// g dk/dsq; kid is program_kids' table. n_instr <= NI.
template <int NI = MAX_BWD_INSTR, int NC>
__device__ __forceinline__ float tree_grad(const int* prog, const int* kid, const float* coef,
                                           int n_instr, float sq, float l2, float g,
                                           float (&tacc)[NC]) {
  float val[NI], adj[NI], lsq[NI];
  float ldc[NI][LEAF_COEF];
#pragma unroll 1
  for (int k = 0; k < n_instr; ++k) {
    const int op = prog[2 * k], off = prog[2 * k + 1];
    if (op == OP_ADD)
      val[k] = val[kid[2 * k]] + val[kid[2 * k + 1]];
    else if (op == OP_MUL)
      val[k] = val[kid[2 * k]] * val[kid[2 * k + 1]];
    else if (op == OP_SCALE)
      val[k] = val[kid[2 * k]] * coef[off];
    else
      leaf_grad(op, coef + off, sq, l2, val[k], ldc[k], lsq[k]);
    adj[k] = 0.0f;
  }
  adj[n_instr - 1] = g;  // the last instruction produces the root
  float gsq = 0.0f;
#pragma unroll 1
  for (int k = n_instr - 1; k >= 0; --k) {
    const int op = prog[2 * k], off = prog[2 * k + 1];
    const float a = adj[k];
    if (op == OP_ADD) {
      adj[kid[2 * k]] += a;
      adj[kid[2 * k + 1]] += a;
    } else if (op == OP_MUL) {
      const int lhs = kid[2 * k], rhs = kid[2 * k + 1];
      adj[lhs] += a * val[rhs];
      adj[rhs] += a * val[lhs];
    } else if (op == OP_SCALE) {
      const int child = kid[2 * k];
      adj[child] += a * coef[off];
      tacc[off] += a * val[child];
    } else {
      const int nc = leaf_coefs(op);
      for (int j = 0; j < nc; ++j) tacc[off + j] += a * ldc[k][j];
      gsq += a * lsq[k];
    }
  }
  return gsq;
}

__device__ __forceinline__ float eval_tree(const int* prog, const float* coef, int n_instr,
                                           float sq, float l2) {
  if (n_instr == 1) return eval_leaf(prog[0], coef + prog[1], sq, l2);
  float st[MAX_STACK];
  int sp = 0;
#pragma unroll 1
  for (int k = 0; k < n_instr; ++k) {
    const int op = prog[2 * k];
    const int off = prog[2 * k + 1];
    if (op == OP_ADD) {
      st[sp - 2] += st[sp - 1];
      --sp;
    } else if (op == OP_MUL) {
      st[sp - 2] *= st[sp - 1];
      --sp;
    } else if (op == OP_SCALE) {
      st[sp - 1] *= coef[off];
    } else {
      st[sp++] = eval_leaf(op, coef + off, sq, l2);
    }
  }
  return st[0];
}

// ------------------------------------------------------------ compiled leaves
//
// A tree of one RBF or Matern leaf can be an instantiation of a sweep (LEAF =
// its opcode; LEAF = 0 is the interpreter above). x is prescaled by
// leaf_x_scale, so that the squared distance already carries the leaf's
// coefficient, and the amplitude c0 is applied to each partial sum, not to
// each entry. K2 (gram_matvec_full.cuh) and K3 (gram_matvec_sym.cuh) share
// this code.

constexpr float LOG2E = 1.4426950408889634f;

// 2^t by the SFU alone (ex2.approx.ftz: about 2 ulp; results below 2^-126
// flush to zero, far below what a kernel entry contributes).
__device__ __forceinline__ float fast_exp2(float t) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}

// One kernel entry from its squared distance. LEAF = 0: the postfix
// interpreter, the whole value. Else the leaf of that opcode without its
// amplitude c0, which the sweep applies to each partial sum, and with x
// prescaled by leaf_x_scale, so that sq already carries the leaf's c1: RBF
// is c0 2^-sq, a Matern's s = c1 l2 is sqrt(sq).
template <int LEAF>
__device__ __forceinline__ float leaf_entry(float sq, const int* prog, const float* coef,
                                            int n_instr, int need_l2) {
  if constexpr (LEAF == 0) {
    return eval_tree(prog, coef, n_instr, sq, need_l2 ? sqrtf(sq) : 0.0f);
  } else if constexpr (LEAF == OP_RBF) {
    return fast_exp2(-sq);
  } else {
    static_assert(LEAF == OP_MATERN12 || LEAF == OP_MATERN32 || LEAF == OP_MATERN52);
    const float s = sqrtf(sq);
    const float e = fast_exp2(s * -LOG2E);
    if constexpr (LEAF == OP_MATERN12) {
      return e;
    } else if constexpr (LEAF == OP_MATERN32) {
      return (1.0f + s) * e;
    } else {
      return (1.0f + s + s * s * (1.0f / 3.0f)) * e;
    }
  }
}

// A compiled leaf's backward terms for one entry of weight w (a pair weight
// or a cotangent) on the prescaled squared distance sq: the sums of the two
// coefficient derivatives, t0 += w f and t1 += w h, with RBF f = 2^-sq,
// h = f sq, and a Matern's s = sqrt(sq), f = p(s) e^-s, h = (p' - p) s e^-s
// (the wrapper rescales them: kernel_ops.bwd_sym_coef); with PHI, also the
// entry's x-gradient weight q = w phi, where dk/dx_i = phi (x'_i - x'_j)
// times a constant of the coefficients (kernel_ops.gram_bwd_dx_scale):
// RBF phi = f; Matern 1/2 phi = e^-s / s (0 at s = 0: coincident points add
// nothing, leaf_grad's rule), 3/2 e^-s, 5/2 (1 + s) e^-s.
template <int LEAF, bool PHI>
__device__ __forceinline__ void leaf_bwd_terms(float sq, float w, float& t0, float& t1,
                                               float& q) {
  if constexpr (LEAF == OP_RBF) {
    const float we = w * fast_exp2(-sq);
    t0 += we;
    t1 = fmaf(we, sq, t1);
    if constexpr (PHI) q = we;
  } else {
    static_assert(LEAF == OP_MATERN12 || LEAF == OP_MATERN32 || LEAF == OP_MATERN52);
    const float s = sqrtf(sq);
    const float we = w * fast_exp2(s * -LOG2E);
    if constexpr (LEAF == OP_MATERN12) {  // p = 1
      t0 += we;
      t1 = fmaf(-we, s, t1);
      if constexpr (PHI) q = s > 0.0f ? we / s : 0.0f;
    } else if constexpr (LEAF == OP_MATERN32) {  // p = 1 + s
      t0 = fmaf(we, 1.0f + s, t0);
      t1 = fmaf(-we, s * s, t1);
      if constexpr (PHI) q = we;
    } else {  // p = 1 + s + s^2 / 3
      t0 = fmaf(we, 1.0f + s + s * s * (1.0f / 3.0f), t0);
      t1 = fmaf(-we, s * s * (1.0f + s) * (1.0f / 3.0f), t1);
      if constexpr (PHI) q = we * (1.0f + s);
    }
  }
}

// The factor a compiled leaf's x is scaled by: RBF c0 exp(c1 sq), c1 <= 0,
// is c0 2^-(sq') for x' = sqrt(-c1 log2 e) x; a Matern's c1 l2 is the
// distance of x' = c1 x. 1 for the interpreter.
template <int LEAF>
__device__ __forceinline__ float leaf_x_scale(float c1) {
  if constexpr (LEAF == 0) return 1.0f;
  if constexpr (LEAF == OP_RBF) return sqrtf(-c1 * LOG2E);
  return c1;
}

// A compiled leaf's amplitude and x scale from its coefficients (the
// program's one instruction points at them); 1 and 1 for the interpreter.
template <int LEAF>
__device__ __forceinline__ void leaf_scales(const int* prog, const float* coef, float& amp,
                                            float& xs) {
  amp = 1.0f;
  xs = 1.0f;
  if constexpr (LEAF != 0) {
    const float* c = coef + prog[1];
    amp = c[0];
    xs = leaf_x_scale<LEAF>(c[1]);
  }
}

__device__ __forceinline__ void load_program(float* s_coef, int* s_prog, const int* prog,
                                             int n_instr, const float* coef, int n_coef) {
  for (int i = threadIdx.x; i < n_coef; i += THREADS) s_coef[i] = coef[i];
  for (int i = threadIdx.x; i < 2 * n_instr; i += THREADS) s_prog[i] = prog[i];
}

// rows [row0, row0 + TILE) of x (n x d) into dst, row-major or transposed;
// rows past n are zero.
__device__ __forceinline__ void load_x(float* dst, const float* x, int row0, int n, int d,
                                       bool transpose) {
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int rr = idx / d, k = idx - rr * d;
    const int row = row0 + rr;
    const float val = row < n ? x[(size_t)row * d + k] : 0.0f;
    if (transpose)
      dst[k * TILE + rr] = val;
    else
      dst[idx] = val;
  }
}

// ------------------------------------------------- copies and TF32 MMAs
//
// Shared by the sweeps on the tensor cores: K2 (gram_matvec_full.cuh) and
// K4's full sweep (gram_matvec_bwd.cuh).

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a rounded to TF32 (10 mantissa bits), ties away from zero
__device__ __forceinline__ unsigned tf32_rna(float a) {
  unsigned t;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(t) : "f"(a));
  return t;
}

// c += a b for one 16 x 8 x 8 tile: A row-major, B column-major, TF32 in,
// fp32 accumulated
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a split into TF32 hi = cvt.rna(a) and lo = cvt.rna(a - hi), so that
// hi + lo carries about fp32's precision (3xTF32); lo is 0 where hi is
// infinite, so an infinite value stays infinite rather than NaN.
__device__ __forceinline__ void tf32_split(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  const float h = __uint_as_float(hi);
  lo = isinf(h) ? 0u : tf32_rna(a - h);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

bool bad_program(int n_instr, int n_coef) {
  return n_instr < 1 || n_instr > MAX_INSTR || n_coef < 0 || n_coef > MAX_COEF;
}

}  // namespace
