// K4's full backward sweep for NVIDIA Hopper (sm_90a): for
// L = <ct, K(x1, x2) V>, dL/dcoef (the gradient in the coefficient vector of
// the kernel's postfix program) and, where asked, dL/dx1, without forming K
// or G. Replaces _matvec_bwd_sweep of the JAX package's
// ops/pallas/kernel_ops.py (:518, called at :587) for cross-set calls, calls
// that want dx, and same-set calls whose forward took the full sweep; the
// symmetric sweep (gram_matvec_bwd_sym.cuh) keeps the same-set calls that
// want no dx after a symmetric forward. dL/dx2 is a second launch with the
// roles swapped (x2, x1, ct, V), as in the JAX package. The kernel template
// lives here so that its instantiations can be compiled in several sources
// at once: gram_matvec_bwd.cu (the staging pass, the launcher and the
// interpreted trees), gram_matvec_bwd_rbf.cu and gram_matvec_bwd_matern*.cu
// (one compiled leaf each).
//
// What it computes, per entry (i, j) of the n x m grid, with G = ct V^T:
//   dcoef[k] += G_ij dk(sq_ij)/dcoef_k
//   dx1[i]   += G_ij dk/dsq 2 (a_i - b_j)               (when dx is wanted)
// with a, b the centred coordinates and sq the direct fp32 sum of squared
// differences, as in the forward kernels; a coincident pair adds nothing to
// dx (leaf_grad's rule).
//
// What bounds it on this card. The sweep evaluates all n m entries (1.05e10
// at n = m = 102400): the entry (3d operations and one exponential), its
// leaf's coefficient terms and, with dx, d FMAs; and G_ij, an r-term dot.
// On the fp32 pipe G alone is 2 r operations an entry (r = 65: 130 against
// about 25 for the rest); by 3xTF32 MMAs it is 3 x 2 n m r operations at
// 495 TFLOP/s (8.3 ms at n = 102400, r = 65; the MMAs' padding to 72
// columns issues 9.2), beside about 4 ms of entry work on the fp32 pipe
// and 2.5 ms of exponentials on the SFU. x, V and ct are a few MB and stay
// in L2.
//
// What the design does about it:
//   * G never leaves registers. G = ct V^T is an MMA whose A operand is the
//     block's rows of ct and whose B operand is V^T; each thread evaluates
//     the kernel entries at exactly the positions its C fragment holds (rows
//     lane / 4 and lane / 4 + 8 of its warp's 16, columns 2 (lane % 4) and
//     2 (lane % 4) + 1 of each 8-column tile), so no G tile passes through
//     shared memory and no barrier guards one. This mirrors K2
//     (gram_matvec_full.cuh), which evaluates entries where its A fragments
//     need them.
//   * G by the route r asks for (kernel_ops.bwd_full_passes). A wide pass
//     (8, 16, 24, 32, 48 or 72 columns) is mma.sync.m16n8k8 in 3xTF32: ct
//     split into TF32 hi and lo once per block and held as A fragments in
//     registers for the whole sweep; V split once by the staging pass into
//     B-fragment order (per 64-row stage, 8-column tile, k-step and lane one
//     float4 hi(c), hi(c + 4), lo(c), lo(c + 4)), one conflict-free 16-byte
//     load a fragment; lo hi and hi lo accumulate into one C, hi hi into
//     another, and a rounded fp32 add joins them (the dropped lo lo is
//     2^-22 relative: fp32's precision, which the JAX sweep keeps with
//     Precision.HIGHEST). Four 8-column tiles are in flight at once. A
//     narrow pass (1, 2 or 4 columns) is a register outer product: the
//     thread's two rows of ct in registers, its two columns of V read from
//     the stage, R FMAs an entry. Wider V runs in passes (blockIdx.z),
//     whose partials add, since the gradients are linear in the columns;
//     at most 72 columns a pass, so that the A fragments (72 registers) and
//     the rest fit without spilling.
//   * Compiled leaves. A tree of one RBF or Matern leaf is an instantiation
//     (LEAF = its opcode) on x prescaled by leaf_x_scale, summing only
//     S0 = sum G f and S1 = sum G h (leaf_bwd_terms), which the wrapper
//     rescales (kernel_ops.bwd_sym_coef), as K4's symmetric sweep and K5's
//     backward do; x at width D = 4 in registers for d <= 4. Every other
//     tree takes LEAF = 0, tree_grad's interpreter, with d read in a loop
//     (D = 0) up to d = 8.
//   * dx in registers, in the direct form. With D = 4 each thread adds
//     q (a'_i - b'_j)_k into 2 x 4 accumulators, q = G phi (compiled) or
//     G dk/dsq (interpreted), reusing the differences it formed for sq; at
//     the end the four lanes that share a row sum by a butterfly. The
//     rewrite a sum W - sum W b cancels, so it is not used. The wrapper scales
//     the sums back to the caller's coordinates
//     (kernel_ops.gram_bwd_dx_scale). With D = 0 (d is only known at run
//     time) the four lanes sum each 8-column tile's terms by a butterfly
//     and the lane that owns the dimension adds them into the row's slot of
//     the block's own dx partial in global memory, which only that lane
//     reads or writes. A call that wants no dx runs an instantiation
//     without any of it.
//   * Any d. With D = 0 the x1 rows are read from global memory (the
//     read-only path; a block's rows stay in L1 at the usual d) and the dx
//     sums live in the partial, so shared memory holds only the x2 and V
//     stages. Past the widths above the wrapper takes the sliced layout
//     (D = X_SLICED, gram_matvec_slice.cuh), which measured 1.7x faster
//     than D = 0 at d = 9 (r = 65; 1.35x with dx) and 11-14x at d = 64
//     (PERF.md): x1 prescaled into a
//     padded copy, and each step stages 32 coordinates of the block's x1
//     rows and of the stage's x2 rows (cp.async, double-buffered; V with a
//     stage's first step). A thread sums the squared distances of its 32
//     C-fragment entries of the stage in registers across the slices; then
//     G and the entries' terms, as D = 0 takes them, which turns each sum
//     into the entry's dx weight q. With dx a second walk over the stage's
//     slices adds q (a_k - b_k) into the row's slot, slice by slice: the
//     four lanes of a row sum each coordinate's terms of the stage by a
//     butterfly and the lane that owns the coordinate adds them in.
//   * A grid that fills the card. A block owns 128 rows of x1 (8 warps x
//     16) and walks its share of the x2 stages (64 rows, double-buffered
//     with cp.async, one block barrier a stage). Where there are too few
//     row blocks, blockIdx.y splits the stages (kernel_ops.bwd_full_split,
//     from the blocks the card holds at once): n = 4096 is 32 row blocks,
//     split in about 4 on 132 SMs.
//   * Equal bits on every run, with no atomics: a thread sums its
//     coefficient terms in fp32 over a stage, then in float64; the block
//     reduces a warp's lanes by a fixed butterfly, then the warps in order,
//     and writes one float64 partial per pass, split, row block and sum;
//     dx is one fp32 partial per pass and split. The wrapper sums the
//     partials in a fixed order.
//   * Ragged edges: the staging pass zero-pads x2 and V past m (and V past
//     r); ct rows past n and columns past r are zero in the fragments, so
//     padded entries meet a zero G. A NaN in V, ct or the coefficients
//     reaches the sums as a product with it would.

#pragma once

#include "gram_matvec_slice.cuh"

// What one launch of the sweep reads and writes (device pointers).
struct BwdFullArgs {
  const float* x1;   // n x d, centred; sliced: prescaled, 128-row blocks x dx, zero past d
  const float* x2s;  // m_pad x dx: x2 prescaled, zero past m and past d
  const float* vs;   // passes x m_pad x (2 W or W): V staged (B fragments, or rows)
  const float* ct;   // n x r
  double* part;      // (passes x splits x row blocks) x the route's sums
  float* pdx;        // (passes x splits) x n x d, or null when no dx is wanted
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int n, m_pad, d, dx, r, need_l2;
};

// The launch's shape, chosen by the wrapper.
struct BwdFullPlan {
  int leaf;    // 0: the interpreter, else the compiled leaf's opcode
  int mma;     // 1: G by 3xTF32 MMAs, 0: by FMAs
  int width;   // V columns a pass
  int D;       // x width in registers (4, compiled), 0 (a loop over d, interpreted), or X_SLICED
  int want_dx;
};

// Launches one instantiation on grid, or, given resident, writes there the
// blocks of it that the card holds at once (at a.d) and launches nothing.
typedef cudaError_t (*BwdFullFn)(const BwdFullArgs& a, dim3 grid, cudaStream_t st,
                                 int* resident);

namespace {

constexpr int BF_WARPS = THREADS / 32;
constexpr int BF_ROWS = 16 * BF_WARPS;  // x1 rows of a block
constexpr int BF_STAGE = 64;            // x2 rows of a stage
constexpr int BF_TILES = BF_STAGE / 8;  // 8-column tiles of G a stage
constexpr int BF_NJ = 4;                // tiles in flight on the MMA route

// The float64 sums a block writes: S0 and S1 for a compiled leaf, one per
// coefficient for the interpreter.
template <int LEAF>
__host__ __device__ constexpr int bf_sums() {
  return LEAF == 0 ? MAX_BWD_COEF : 2;
}

// Floats of V a stage holds: 64 rows x W columns, twice over (hi and lo)
// on the MMA route.
__host__ __device__ constexpr int bf_vstage(bool mma, int w) {
  return BF_STAGE * w * (mma ? 2 : 1);
}

// Sliced layout (D = X_SLICED): a step's slices of the block's x1 rows and
// the stage's x2 rows.
constexpr int BF_SLICE_BUF = (BF_ROWS + BF_STAGE) * X_SLICE_LD;

// Floats of x a buffer holds: an x2 stage at width dx, or a step's slices.
template <int D>
__host__ __device__ inline int bf_x_floats(int dx) {
  return D == X_SLICED ? BF_SLICE_BUF : BF_STAGE * dx;
}

// Shared memory of one block, in bytes, for xf floats of x a buffer: the
// block's reduction (as doubles), two buffers of x and two stages of V, the
// program and its operand table.
__host__ __device__ inline size_t bf_smem_bytes(bool mma, int w, int xf) {
  return sizeof(double) * BF_WARPS * MAX_BWD_COEF +
         sizeof(float) * ((size_t)2 * (xf + bf_vstage(mma, w)) + MAX_BWD_COEF +
                          4 * MAX_BWD_INSTR);
}

// Blocks an SM should hold at least: the interpreter and the wide MMA
// passes need the registers of one.
template <bool MMA, int W, int LEAF>
__host__ __device__ constexpr int bf_min_blocks() {
  return (LEAF == 0 || (MMA && W > 16)) ? 1 : 2;
}

template <bool MMA, int W, int D, int LEAF, bool DX>
__global__ void __launch_bounds__(THREADS, bf_min_blocks<MMA, W, LEAF>())
    matvec_bwd_full_kernel(BwdFullArgs a) {
  constexpr int KS = MMA ? W / 8 : 1;  // k-steps of the MMA route
  constexpr int NS = bf_sums<LEAF>();
  constexpr int VST = bf_vstage(MMA, W);
  constexpr int DR = D > 0 ? D : 1;
  static_assert(!MMA || W % 8 == 0, "an MMA pass is whole 8-column k-steps");
  const int n = a.n, d = a.d, dx = a.dx;

  extern __shared__ __align__(16) float smem[];
  double* s_red = reinterpret_cast<double*>(smem);           // warps x MAX_BWD_COEF
  float* s_stage = smem + 2 * BF_WARPS * MAX_BWD_COEF;         // 2 x (x2 stage, V stage)
  const int stage_f = bf_x_floats<D>(dx) + VST;
  float* s_coef = s_stage + 2 * stage_f;                       // MAX_BWD_COEF
  int* s_prog = reinterpret_cast<int*>(s_coef + MAX_BWD_COEF);  // 2 MAX_BWD_INSTR
  int* s_kid = s_prog + 2 * MAX_BWD_INSTR;                      // 2 MAX_BWD_INSTR

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BF_ROWS;
  const int wrow = 16 * warp + gid;  // the thread's rows in the block: wrow, wrow + 8
  const int split = blockIdx.y, splits = gridDim.y, pass = blockIdx.z;
  const int c0 = pass * W;  // the pass's first column of V and ct
  const int stages = a.m_pad / BF_STAGE;
  const int t0 = (int)((long long)stages * split / splits);
  const int t1 = (int)((long long)stages * (split + 1) / splits);
  const size_t slot = (size_t)pass * splits + split;  // this block's pass and split

  if constexpr (LEAF == 0) load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
  float amp, xs;  // x's scale; the wrapper applies the amplitude
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);
  (void)amp;

  // the thread's two rows of x1: prescaled in registers (D > 0), or their
  // rows in global memory (D = 0; a row past n reads row n - 1, and its
  // zero row of ct keeps it out of every sum) with their dx slots in this
  // block's partial, zeroed by the lanes that own them
  float xr[2][DR];
  const float* xg[2];
  float* dxg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wrow + 8 * h;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        xr[h][k] = (row < n && k < d) ? xs * a.x1[(size_t)row * d + k] : 0.0f;
    } else {
      xg[h] = a.x1 + (size_t)min(row, n - 1) * d;
      dxg[h] = nullptr;
      if constexpr (DX) {
        if (row < n) {
          dxg[h] = a.pdx + (slot * n + row) * d;
          for (int k = tig; k < d; k += 4) dxg[h][k] = 0.0f;
        }
      }
    }
  }
  (void)xg;
  (void)dxg;

  // the thread's rows of ct: A fragments (hi, lo) of every k-step, or the
  // two rows' W values; zero past n and past r
  unsigned ahi[MMA ? KS : 1][4], alo[MMA ? KS : 1][4];
  float cr[2][MMA ? 1 : W];
  if constexpr (MMA) {
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a0 .. a3: rows gid, gid + 8 at k tig, then tig + 4
        const int row = row0 + wrow + 8 * (f & 1);
        const int col = c0 + 8 * s + tig + 4 * (f >> 1);
        const float val = (row < n && col < a.r) ? a.ct[(size_t)row * a.r + col] : 0.0f;
        tf32_split(val, ahi[s][f], alo[s][f]);
      }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wrow + 8 * h;
#pragma unroll
      for (int c = 0; c < W; ++c)
        cr[h][c] = (row < n && c0 + c < a.r) ? a.ct[(size_t)row * a.r + c0 + c] : 0.0f;
    }
  }

  const float* vsrc = a.vs + (size_t)pass * a.m_pad * (VST / BF_STAGE);
  auto stage = [&](int t, int buf) {
    float* sx = s_stage + buf * stage_f;
    const float4* gx = reinterpret_cast<const float4*>(a.x2s + (size_t)t * BF_STAGE * dx);
    for (int e = threadIdx.x; e < BF_STAGE * dx / 4; e += THREADS)
      cp_async16(reinterpret_cast<float4*>(sx) + e, gx + e);
    const float4* gv = reinterpret_cast<const float4*>(vsrc + (size_t)t * VST);
    float4* sv = reinterpret_cast<float4*>(sx + BF_STAGE * dx);
    for (int e = threadIdx.x; e < VST / 4; e += THREADS) cp_async16(sv + e, gv + e);
    cp_async_commit();
  };

  float dxa[2][DR];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < DR; ++k) dxa[h][k] = 0.0f;
  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;
  float tsum[NS];

  // The four entries of 8-column tile jt of the stage at sx whose G the
  // thread holds in g (C-fragment order: rows h = e / 2, columns
  // 2 tig + e % 2): their coefficient terms into tsum, their dx terms.
  auto entries = [&](const float* sx, int jt, const float (&g)[4]) {
    const float* xb[2] = {sx + (8 * jt + 2 * tig) * dx, sx + (8 * jt + 2 * tig + 1) * dx};
    float xq[2][DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int k = 0; k < D; k += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(xb[c] + k);
          xq[c][k] = t4.x;
          xq[c][k + 1] = t4.y;
          xq[c][k + 2] = t4.z;
          xq[c][k + 3] = t4.w;
        }
    }
    float q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = e & 1;
      float sq = 0.0f;
      float diff[DR];
      if constexpr (D > 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = xr[h][k] - xq[c][k];
          sq = fmaf(diff[k], diff[k], sq);
        }
      } else {
        // x1 scaled as the staging pass scales x2, by a product that is never
        // fused into the difference: a coincident pair meets sq = 0
        for (int k = 0; k < d; ++k) {
          const float u = __fmul_rn(xs, __ldg(xg[h] + k)) - xb[c][k];
          sq = fmaf(u, u, sq);
        }
      }
      if constexpr (LEAF == 0) {
        q[e] = tree_grad(s_prog, s_kid, s_coef, a.n_instr, sq, a.need_l2 ? sqrtf(sq) : 0.0f,
                         g[e], tsum);
      } else {
        leaf_bwd_terms<LEAF, DX>(sq, g[e], tsum[0], tsum[1], q[e]);
      }
      if constexpr (DX && D > 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) dxa[h][k] = fmaf(q[e], diff[k], dxa[h][k]);
      }
    }
    if constexpr (DX && D == 0) {
      // per row and dimension: the tile's 8 columns by the four lanes, then
      // the lane that owns the dimension adds them into the row's slot
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int k = 0; k < d; ++k) {
          const float xv = __fmul_rn(xs, __ldg(xg[h] + k));
          float p = fmaf(q[2 * h], xv - xb[0][k], q[2 * h + 1] * (xv - xb[1][k]));
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          if ((k & 3) == tig && dxg[h] != nullptr) dxg[h][k] += p;
        }
      }
    }
  };

  if constexpr (LEAF == 0) {
    __syncthreads();  // the program is in place
    if (threadIdx.x == 0) program_kids(s_prog, a.n_instr, s_kid);
  }
  if constexpr (D == X_SLICED) {
    // A stage is nsl steps of slices, then with dx nsl more (the second
    // walk). Two buffers of slices, then two of V (a stage's first step
    // brings V), in the stage buffers' place; x1 is the prescaled copy.
    const int nsl = dx / X_SLICE, per = (DX ? 2 : 1) * nsl, steps = (t1 - t0) * per;
    float* s_vb = s_stage + 2 * BF_SLICE_BUF;
    auto issue = [&](int u) {
      const int t = t0 + u / per, c = (u % per) % nsl;
      slice_rows<BF_ROWS, BF_STAGE>(s_stage + (u & 1) * BF_SLICE_BUF, a.x1, row0, a.x2s,
                                    t * BF_STAGE, dx, c * X_SLICE);
      if (u % per == 0) {
        const float4* gv = reinterpret_cast<const float4*>(vsrc + (size_t)t * VST);
        float4* sv = reinterpret_cast<float4*>(s_vb + ((t - t0) & 1) * VST);
        for (int e = threadIdx.x; e < VST / 4; e += THREADS) cp_async16(sv + e, gv + e);
      }
      cp_async_commit();
    };
    // the squared distances of the thread's entries of the stage (tile jt,
    // C-fragment order e: row h = e / 2, column 2 tig + e % 2), then their
    // dx weights q
    float sq[BF_TILES][4];
    issue(0);
    for (int u = 0; u < steps; ++u) {
      const int t = t0 + u / per, w = u % per, c = w % nsl;
      cp_async_wait_all();
      __syncthreads();  // step u is in place; every warp is done with step u - 1
      if (u + 1 < steps) issue(u + 1);
      const float* xa = s_stage + (u & 1) * BF_SLICE_BUF;  // the block's x1 rows
      const float* xb = xa + BF_ROWS * X_SLICE_LD;          // the stage's x2 rows
      if (w >= nsl) {
        if constexpr (DX) {
          // dx: per row h and coordinate of the slice, the stage's terms
          // q (a - b) by the four lanes, then the lane that owns it
#pragma unroll 1
          for (int k = 0; k < X_SLICE; k += 4) {
            float4 a4[2], p4[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              a4[h] = *reinterpret_cast<const float4*>(xa + (wrow + 8 * h) * X_SLICE_LD + k);
              p4[h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int jt = 0; jt < BF_TILES; ++jt)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const float4 b4 = *reinterpret_cast<const float4*>(
                    xb + (8 * jt + 2 * tig + cc) * X_SLICE_LD + k);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float q = sq[jt][2 * h + cc];
                  p4[h].x = fmaf(q, a4[h].x - b4.x, p4[h].x);
                  p4[h].y = fmaf(q, a4[h].y - b4.y, p4[h].y);
                  p4[h].z = fmaf(q, a4[h].z - b4.z, p4[h].z);
                  p4[h].w = fmaf(q, a4[h].w - b4.w, p4[h].w);
                }
              }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float pv[4] = {p4[h].x, p4[h].y, p4[h].z, p4[h].w};
#pragma unroll
              for (int o = 0; o < 4; ++o) {
                pv[o] += __shfl_xor_sync(0xffffffffu, pv[o], 1);
                pv[o] += __shfl_xor_sync(0xffffffffu, pv[o], 2);
              }
              const int kk = c * X_SLICE + k + tig;  // the coordinate this lane owns
              const float mine = tig == 0 ? pv[0] : tig == 1 ? pv[1] : tig == 2 ? pv[2] : pv[3];
              if (dxg[h] != nullptr && kk < d) dxg[h][kk] += mine;
            }
          }
        }
        continue;
      }
      if (c == 0) {
#pragma unroll
        for (int jt = 0; jt < BF_TILES; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sq[jt][e] = 0.0f;
      }
#pragma unroll 2
      for (int k = 0; k < X_SLICE; k += 4) {
        float4 a4[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a4[h] = *reinterpret_cast<const float4*>(xa + (wrow + 8 * h) * X_SLICE_LD + k);
#pragma unroll
        for (int jt = 0; jt < BF_TILES; ++jt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float4 b4 = *reinterpret_cast<const float4*>(
                xb + (8 * jt + 2 * tig + cc) * X_SLICE_LD + k);
#pragma unroll
            for (int h = 0; h < 2; ++h) sq_add4(sq[jt][2 * h + cc], a4[h], b4);
          }
      }
      if (c + 1 < nsl) continue;

      // G and the entries' terms, as D = 0 takes them; q replaces sq
      const float* sv = s_vb + ((t - t0) & 1) * VST;
#pragma unroll
      for (int s = 0; s < NS; ++s) tsum[s] = 0.0f;
      auto weigh = [&](int jt, const float (&g)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sqe = sq[jt][e];
          float q;
          if constexpr (LEAF == 0) {
            q = tree_grad(s_prog, s_kid, s_coef, a.n_instr, sqe, a.need_l2 ? sqrtf(sqe) : 0.0f,
                          g[e], tsum);
          } else {
            leaf_bwd_terms<LEAF, DX>(sqe, g[e], tsum[0], tsum[1], q);
          }
          if constexpr (DX) sq[jt][e] = q;
        }
      };
      if constexpr (MMA) {
        const float4* vt = reinterpret_cast<const float4*>(sv);
#pragma unroll
        for (int jg = 0; jg < BF_TILES; jg += BF_NJ) {
          float big[BF_NJ][4], sml[BF_NJ][4];
#pragma unroll
          for (int u2 = 0; u2 < BF_NJ; ++u2)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[u2][e] = sml[u2][e] = 0.0f;
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int u2 = 0; u2 < BF_NJ; ++u2) {
              const float4 b = vt[((jg + u2) * KS + s) * 32 + lane];
              const unsigned bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
              const unsigned bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
              mma_tf32(sml[u2], alo[s], bh0, bh1);
              mma_tf32(sml[u2], ahi[s], bl0, bl1);
              mma_tf32(big[u2], ahi[s], bh0, bh1);
            }
#pragma unroll
          for (int u2 = 0; u2 < BF_NJ; ++u2) {
            float g[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) g[e] = big[u2][e] + sml[u2][e];
            weigh(jg + u2, g);
          }
        }
      } else {
#pragma unroll
        for (int jt = 0; jt < BF_TILES; ++jt) {
          const float* vp = sv + (8 * jt + 2 * tig) * W;
          float vv[2 * W];
          if constexpr (W == 1) {
            const float2 t2 = *reinterpret_cast<const float2*>(vp);
            vv[0] = t2.x;
            vv[1] = t2.y;
          } else {
#pragma unroll
            for (int cw = 0; cw < 2 * W; cw += 4) {
              const float4 t4 = *reinterpret_cast<const float4*>(vp + cw);
              vv[cw] = t4.x;
              vv[cw + 1] = t4.y;
              vv[cw + 2] = t4.z;
              vv[cw + 3] = t4.w;
            }
          }
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, cc = e & 1;
            float sg = 0.0f;
#pragma unroll
            for (int cw = 0; cw < W; ++cw) sg = fmaf(cr[h][cw], vv[cc * W + cw], sg);
            g[e] = sg;
          }
          weigh(jt, g);
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[s] += (double)tsum[s];
    }
  } else {
    stage(t0, 0);
    for (int t = t0; t < t1; ++t) {
      const int buf = (t - t0) & 1;
      cp_async_wait_all();
      __syncthreads();  // stage t is in place; every warp is done with stage t - 1
      if (t + 1 < t1) stage(t + 1, buf ^ 1);
      const float* sx = s_stage + buf * stage_f;
      const float* sv = sx + BF_STAGE * dx;
#pragma unroll
      for (int s = 0; s < NS; ++s) tsum[s] = 0.0f;

      if constexpr (MMA) {
        const float4* vt = reinterpret_cast<const float4*>(sv);
#pragma unroll 1
        for (int jg = 0; jg < BF_TILES; jg += BF_NJ) {
          float big[BF_NJ][4], sml[BF_NJ][4];
#pragma unroll
          for (int u = 0; u < BF_NJ; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[u][e] = sml[u][e] = 0.0f;
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int u = 0; u < BF_NJ; ++u) {
              const float4 b = vt[((jg + u) * KS + s) * 32 + lane];
              const unsigned bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
              const unsigned bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
              mma_tf32(sml[u], alo[s], bh0, bh1);
              mma_tf32(sml[u], ahi[s], bl0, bl1);
              mma_tf32(big[u], ahi[s], bh0, bh1);
            }
#pragma unroll
          for (int u = 0; u < BF_NJ; ++u) {
            float g[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) g[e] = big[u][e] + sml[u][e];
            entries(sx, jg + u, g);
          }
        }
      } else {
#pragma unroll 2
        for (int jt = 0; jt < BF_TILES; ++jt) {
          // the rows of V of the thread's two columns, 2 W floats in a row
          const float* vp = sv + (8 * jt + 2 * tig) * W;
          float vv[2 * W];
          if constexpr (W == 1) {
            const float2 t2 = *reinterpret_cast<const float2*>(vp);
            vv[0] = t2.x;
            vv[1] = t2.y;
          } else {
#pragma unroll
            for (int c = 0; c < 2 * W; c += 4) {
              const float4 t4 = *reinterpret_cast<const float4*>(vp + c);
              vv[c] = t4.x;
              vv[c + 1] = t4.y;
              vv[c + 2] = t4.z;
              vv[c + 3] = t4.w;
            }
          }
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, cc = e & 1;
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < W; ++c) s = fmaf(cr[h][c], vv[cc * W + c], s);
            g[e] = s;
          }
          entries(sx, jt, g);
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[s] += (double)tsum[s];
    }
  }

  if constexpr (DX && D > 0) {
    float* out = a.pdx + slot * n * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wrow + 8 * h;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float u = dxa[h][k];
        u += __shfl_xor_sync(0xffffffffu, u, 1);
        u += __shfl_xor_sync(0xffffffffu, u, 2);
        if (row < n && k < d && (k & 3) == tig) out[(size_t)row * d + k] = u;
      }
    }
  }

  // the block's sums: a warp's lanes by a fixed butterfly, then the warps
  // in order; one float64 partial per pass, split, row block and sum
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    double u = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
    if (lane == 0) s_red[warp * NS + s] = u;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    double u = s_red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < BF_WARPS; ++w) u += s_red[w * NS + threadIdx.x];
    a.part[(slot * gridDim.x + blockIdx.x) * NS + threadIdx.x] = u;
  }
}

// One instantiation, a BwdFullFn.
template <bool MMA, int W, int D, int LEAF, bool DX>
cudaError_t bf_one(const BwdFullArgs& a, dim3 grid, cudaStream_t st, int* resident) {
  auto kernel = matvec_bwd_full_kernel<MMA, W, D, LEAF, DX>;
  const size_t smem = bf_smem_bytes(MMA, W, bf_x_floats<D>(D > 0 ? D : a.d));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  if (resident != nullptr) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *resident = per_sm * sms;
    return err;
  }
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The pass widths: keep in sync with kernel_ops.BWD_FULL_FMA and
// BWD_FULL_MMA.
template <int LEAF, int D, bool DX>
BwdFullFn bf_pick_width(int mma, int width) {
  if (mma) {
    switch (width) {
      case 8: return bf_one<true, 8, D, LEAF, DX>;
      case 16: return bf_one<true, 16, D, LEAF, DX>;
      case 24: return bf_one<true, 24, D, LEAF, DX>;
      case 32: return bf_one<true, 32, D, LEAF, DX>;
      case 48: return bf_one<true, 48, D, LEAF, DX>;
      case 72: return bf_one<true, 72, D, LEAF, DX>;
      default: return nullptr;
    }
  }
  switch (width) {
    case 1: return bf_one<false, 1, D, LEAF, DX>;
    case 2: return bf_one<false, 2, D, LEAF, DX>;
    case 4: return bf_one<false, 4, D, LEAF, DX>;
    default: return nullptr;
  }
}

// A route's instantiation for a plan: D = 4 for a compiled leaf, 0 for the
// interpreter (the sliced layout: bf_pick_sliced).
template <int LEAF>
BwdFullFn bf_pick(const BwdFullPlan& p) {
  constexpr int D = LEAF == 0 ? 0 : 4;
  if (p.D != D) return nullptr;
  return p.want_dx ? bf_pick_width<LEAF, D, true>(p.mma, p.width)
                   : bf_pick_width<LEAF, D, false>(p.mma, p.width);
}

// A route's sliced-layout instantiation for a plan (D = X_SLICED).
template <int LEAF>
BwdFullFn bf_pick_sliced(const BwdFullPlan& p) {
  return p.want_dx ? bf_pick_width<LEAF, X_SLICED, true>(p.mma, p.width)
                   : bf_pick_width<LEAF, X_SLICED, false>(p.mma, p.width);
}

}  // namespace

// The compiled leaves' instantiations (gram_matvec_bwd_rbf.cu,
// gram_matvec_bwd_matern{12,32,52}.cu).
BwdFullFn gm_bwd_full_pick_rbf(const BwdFullPlan& p);
BwdFullFn gm_bwd_full_pick_matern12(const BwdFullPlan& p);
BwdFullFn gm_bwd_full_pick_matern32(const BwdFullPlan& p);
BwdFullFn gm_bwd_full_pick_matern52(const BwdFullPlan& p);
// The sliced layout's instantiations: the interpreter
// (gram_matvec_bwd_sliced.cu), RBF (gram_matvec_bwd_sliced_rbf.cu), the
// Materns (gram_matvec_bwd_sliced_matern.cu).
BwdFullFn gm_bwd_full_pick_sliced(const BwdFullPlan& p);
BwdFullFn gm_bwd_full_pick_sliced_rbf(const BwdFullPlan& p);
BwdFullFn gm_bwd_full_pick_sliced_matern(const BwdFullPlan& p);
