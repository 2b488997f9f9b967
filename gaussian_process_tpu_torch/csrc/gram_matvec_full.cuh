// K2: the full sweep out = K(x1, x2) @ V on the tensor cores, for NVIDIA
// Hopper (sm_90a). Replaces _matvec_fwd_impl of the JAX package's
// ops/pallas/kernel_ops.py (:303), whose output product runs under
// dot_mode="split3" (a 3-pass split product on the MXU) or "highest" (full
// fp32); its Hopper counterpart, 3xTF32, serves both modes (gram_matvec.cu
// says why). The kernel template lives here so that its instantiations can
// be compiled in several sources at once:
// gram_matvec.cu (the interpreted trees and RBF, the staging pass and the
// launcher), gram_matvec_full_matern.cu (the Matern family),
// gram_matvec_full_d8.cu and gram_matvec_full_d8_matern.cu (the compiled
// leaves at D = 8), and gram_matvec_full_sliced.cu and
// gram_matvec_full_sliced_matern.cu (the sliced layout).
//
// What bounds it on this card. At n = m = 102400 and r columns (r_pad, r
// rounded up to a multiple of 8) the product is 3 x 2 n^2 r_pad TF32 MMA
// operations at 495 TFLOP/s dense: 9.2 ms at r = 65 (r_pad 72), 65 ms at
// r = 512. Against it, n^2 ~ 1.05e10 entry evaluations on the fp32 pipe and
// the SFU (about 15 operations an entry at d = 4: 2.4 ms at 67 TFLOP/s).
// x and V are a few hundred MB at most and are read from L2.
//
// What the design does about it:
//   * Entries go straight into A fragments. The product is
//     mma.sync.m16n8k8 with TF32 inputs and fp32 accumulation. A warp owns
//     32 output rows (two 16-row MMA tiles); each thread evaluates exactly
//     the entries its A fragments hold (rows lane / 4 and lane / 4 + 8 of
//     each 16, k-columns lane % 4 and lane % 4 + 4 of each 8-deep k-step)
//     into registers, so the K tile never touches shared memory and no
//     barrier guards it. The thread's x1 rows stay in registers for the
//     whole sweep.
//   * 3xTF32. Each entry and each V value is split into hi = cvt.rna.tf32(a)
//     and lo = cvt.rna.tf32(a - hi); lo * hi and hi * lo are accumulated
//     first, then hi * hi (CUTLASS's order), and lo * lo is dropped: about
//     fp32's precision at a third of the tensor cores' TF32 rate.
//   * Sums that do not drift. The MMA rounds its add into C toward zero, so
//     a C carried over the sweep drifts by about one ulp an add, past the
//     2e-4 x max |plain| gate at n = 102400. Each pair of k-steps goes
//     into a zeroed partial (six MMAs a tile), and a rounded fp32 add takes
//     it into the sum, which leaves the sweep more precise than fp32 FMAs.
//   * V is split once, by the staging pass (full_stage_kernel, one launch
//     before the sweep), into a global array already in the B-fragment
//     order: per pass, k-step, 8-column tile and lane one float4
//     (hi(k), hi(k + 4), lo(k), lo(k + 4)). A lane reads its fragment with
//     one conflict-free 16-byte shared load. The same pass prescales x2 and
//     pads it with zero rows and coordinates.
//   * Staging. Each block copies the x2 and V fragments of the next stage
//     (64 x2 rows) with cp.async, double-buffered, while its warps run this
//     stage's MMAs: one block barrier a stage.
//   * Column passes follow r. A pass is NT tiles of 8 columns, NT one of
//     the compiled counts (1-6, 8, 9, 12, 16; kernel_ops.full_passes): r = 65
//     computes 72 columns, r = 9 16, r = 1 8. Wider V is cut into the fewest
//     passes of at most 128 columns, so r = 512 is 4 passes (each entry is
//     evaluated 4 times): 256-column passes at 16 rows a warp ran slower,
//     their 128 accumulators a thread spilling at 255 registers. Every tile
//     of an instantiation is computed, with no branch, so the compiler
//     interleaves the tiles' MMAs.
//   * 128 rows a block: 8 warps, 4 row groups x 2 halves of each stage's
//     k-steps, summed through shared memory at the end in a fixed order:
//     every output row is written once, with no atomics, so two runs give
//     equal bits.
//   * Compiled leaves, as in K3 (gram_matvec_common.cuh): one RBF or Matern
//     leaf is an instantiation with prescaled x (RBF: one ex2 an entry) and
//     the amplitude applied to the sums; x in registers at width D = 4 for
//     d <= 4 and D = 8 for 5 <= d <= 8, zero past d in x1's registers and in
//     the staged x2, so the padding adds fma(0, 0, sq) = sq and the squared
//     distance keeps its bits. Every other tree takes the postfix
//     interpreter (LEAF = 0),
//     with x1's rows and the x2 stages at full width in shared memory and d
//     read in a loop (D = 0), up to d = 8. The wrapper picks the route and
//     the layout before the launch.
//   * Any d (D = X_SLICED, gram_matvec_slice.cuh): past those widths x1 is
//     prescaled into a copy, and each step stages 32 coordinates of the
//     block's x1 rows and of the stage's x2 rows (cp.async,
//     double-buffered; V's fragments with a stage's first step). A thread
//     sums the squared distances of the 32 A-fragment entries it owns in a
//     stage (MT x 4 k-steps x 4) in registers across the slices: the slice
//     loop wraps the stage's k-steps, so V's fragments are read once. Then
//     it evaluates them and runs the stage's MMAs as above. Shared memory
//     does not grow with d. Against D = 0 it measured 1.6x faster at d = 9
//     and 10x at d = 64 (PERF.md).
//   * Ragged edges: the staging pass zero-pads V rows past m and columns past
//     r, and gives x2 rows past m zero coordinates, so their entries are
//     finite and meet zero V. A NaN in V or in the coefficients reaches the
//     output as a product with it would.

#pragma once

#include "gram_matvec_slice.cuh"

// What one launch of the sweep reads and writes (device pointers).
struct FullArgs {
  const float* x1;   // n x d, centred; sliced: prescaled, 128-row blocks x dx
  const float* x2s;  // m_pad x dx: x2 prescaled, zero past m and past d
  const float* vf;   // passes x (m_pad / 8) x nt x 32 x 4: V's B fragments, hi and lo
  float* out;        // n x r
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int n, m_pad, d, dx, r, nt, need_l2;
};

// The compiled leaves' instantiations at D = 8: RBF and Matern 1/2
// (gram_matvec_full_d8.cu), Matern 3/2 and 5/2 (gram_matvec_full_d8_matern.cu).
cudaError_t gm_full_launch_d8(const FullArgs& a, int leaf, int passes, cudaStream_t st);
cudaError_t gm_full_launch_d8_matern(const FullArgs& a, int leaf, int passes, cudaStream_t st);

namespace {

constexpr int FULL_ROWS = 128;   // x1 rows of a block
constexpr int FULL_WARPS = THREADS / 32;
constexpr int FULL_STAGE = 64;   // x2 rows of a stage: 8 k-steps, 4 a k-half
constexpr int FULL_M_ALIGN = FULL_STAGE;  // x2 rows are padded to whole stages

// a step's slices of the block's x1 rows and the stage's x2 rows (sliced)
constexpr int FULL_SLICE_BUF = (FULL_ROWS + FULL_STAGE) * X_SLICE_LD;

// Shared memory of one block, in floats: the program, x1's rows (D = 0),
// two stages of x2 (in the sliced layout two steps' slices of x1 and x2 in
// their place) and two of V's fragments (aliased by the k-halves' sum at the
// end).
template <int D>
__host__ __device__ inline size_t full_smem_floats(int d, int dx, int nt) {
  return (size_t)MAX_COEF + 2 * MAX_INSTR +
         (D == X_SLICED ? 2 * FULL_SLICE_BUF
                        : (D == 0 ? FULL_ROWS * d : 0) + 2 * FULL_STAGE * dx) +
         2 * 16 * FULL_STAGE * nt;
}

// The blocks an SM ptxas is told to fit (0: not told). At D = 8 the
// instantiations of 6-9 tiles take over 128 registers, so one block an SM
// in any case; left to itself ptxas stops at 164-168 registers and runs
// NT = 9's MMAs one dependent chain at a time (79 of 108 HMMAs wait on the
// one before). Told one block, it keeps the two row tiles' chains apart:
// r = 65 at n = 40000 7.5 -> 5.7 ms (PERF.md). 12 and 16 tiles take 255
// registers either way, and told so would spill.
constexpr int full_min_blocks(int nt, int d) { return d == 8 && nt >= 6 && nt <= 9 ? 1 : 0; }

template <int NT, int D, int LEAF>
__global__ void __launch_bounds__(THREADS, full_min_blocks(NT, D))
    matvec_full_tc_kernel(FullArgs a) {
  constexpr int MT = 2;                   // 16-row MMA tiles a warp
  constexpr int WR = FULL_ROWS / (16 * MT);  // row groups of the block
  constexpr int KS = FULL_STAGE / 8 / 2;  // k-steps a k-half takes of each stage
  constexpr int VSTAGE = 16 * FULL_STAGE * NT;  // floats of V's fragments a stage
  static_assert(2 * WR == FULL_WARPS && KS % 2 == 0, "block shape");
  const int n = a.n, d = a.d, dx = a.dx;

  extern __shared__ __align__(16) float smem[];
  float* s_coef = smem;
  int* s_prog = reinterpret_cast<int*>(smem + MAX_COEF);
  // FULL_ROWS x d (D = 0); 2 x FULL_SLICE_BUF (sliced)
  float* s_x1 = smem + MAX_COEF + 2 * MAX_INSTR;
  // 2 x FULL_STAGE x dx (none sliced)
  float* s_x2 = s_x1 + (D == 0 ? FULL_ROWS * d : D == X_SLICED ? 2 * FULL_SLICE_BUF : 0);
  float* s_v = s_x2 + (D == X_SLICED ? 0 : 2 * FULL_STAGE * dx);  // 2 x VSTAGE

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % WR, kg = warp / WR;  // row group, k-half
  const int row0 = blockIdx.x * FULL_ROWS;
  const int wrow = rg * 16 * MT;  // the warp's first row within the block
  const int pass = blockIdx.y;

  if constexpr (LEAF == 0) load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
  float amp, xs;  // the leaf's amplitude (applied to the sums), x's scale
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);

  // the thread's x1 rows: wrow + 16 i + gid + 8 h
  float xr[MT][2][D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + 16 * i + gid + 8 * h;
#pragma unroll
        for (int k = 0; k < D; ++k)
          xr[i][h][k] = (row < n && k < d) ? xs * a.x1[(size_t)row * d + k] : 0.0f;
      }
  } else if constexpr (D == 0) {
    for (int e = threadIdx.x; e < FULL_ROWS * d; e += THREADS)
      s_x1[e] = row0 + e / d < n ? xs * a.x1[(size_t)row0 * d + e] : 0.0f;
  }

  const float* vsrc = a.vf + (size_t)pass * (a.m_pad / 8) * NT * 128;
  auto stage = [&](int t, int buf) {
    const float4* gx = reinterpret_cast<const float4*>(a.x2s + (size_t)t * FULL_STAGE * dx);
    float4* sx = reinterpret_cast<float4*>(s_x2 + buf * FULL_STAGE * dx);
    for (int e = threadIdx.x; e < FULL_STAGE * dx / 4; e += THREADS) cp_async16(sx + e, gx + e);
    const float4* gv = reinterpret_cast<const float4*>(vsrc + (size_t)t * VSTAGE);
    float4* sv = reinterpret_cast<float4*>(s_v + buf * VSTAGE);
    for (int e = threadIdx.x; e < VSTAGE / 4; e += THREADS) cp_async16(sv + e, gv + e);
    cp_async_commit();
  };

  // the thread's A fragments of k-step s of stage x2t: a0 .. a3 are rows
  // gid, gid + 8 at k-column tig, then at tig + 4; split into hi and lo
  auto fragments = [&](const float* x2t, int s, unsigned (&hi)[MT][4], unsigned (&lo)[MT][4]) {
    const float* xb[2] = {x2t + (8 * s + tig) * dx, x2t + (8 * s + tig + 4) * dx};
    float xq[2][D > 0 ? D : 1];
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
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int h = f & 1, c = f >> 1;
        float sq = 0.0f;
        if constexpr (D > 0) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float dd = xr[i][h][k] - xq[c][k];
            sq = fmaf(dd, dd, sq);
          }
        } else {
          const float* xa = s_x1 + (wrow + 16 * i + gid + 8 * h) * d;
          for (int k = 0; k < d; ++k) {
            const float dd = xa[k] - xb[c][k];
            sq = fmaf(dd, dd, sq);
          }
        }
        const float ent = leaf_entry<LEAF>(sq, s_prog, s_coef, a.n_instr, a.need_l2);
        hi[i][f] = tf32_rna(ent);
        lo[i][f] = tf32_rna(ent - __uint_as_float(hi[i][f]));
      }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int stages = a.m_pad / FULL_STAGE;
  if constexpr (D == X_SLICED) {
    // step u: slice c of stage t; x1 is the prescaled copy, dx its width
    const int nsl = dx / X_SLICE, steps = stages * nsl;
    auto issue = [&](int u) {
      const int t = u / nsl, c = u - t * nsl;
      slice_rows<FULL_ROWS, FULL_STAGE>(s_x1 + (u & 1) * FULL_SLICE_BUF, a.x1, row0, a.x2s,
                                        t * FULL_STAGE, dx, c * X_SLICE);
      if (c == 0) {
        const float4* gv = reinterpret_cast<const float4*>(vsrc + (size_t)t * VSTAGE);
        float4* sv = reinterpret_cast<float4*>(s_v + (t & 1) * VSTAGE);
        for (int e = threadIdx.x; e < VSTAGE / 4; e += THREADS) cp_async16(sv + e, gv + e);
      }
      cp_async_commit();
    };
    // the squared distances of the thread's A-fragment entries of the
    // k-half's k-steps: [k-step][i][f], f as in fragments
    float sq[KS][MT][4];
    issue(0);
    for (int u = 0; u < steps; ++u) {
      const int t = u / nsl, c = u - t * nsl;
      cp_async_wait_all();
      __syncthreads();  // step u is in place; every warp is done with step u - 1
      if (u + 1 < steps) issue(u + 1);
      if (c == 0) {
#pragma unroll
        for (int q = 0; q < KS; ++q)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int f = 0; f < 4; ++f) sq[q][i][f] = 0.0f;
      }
      const float* xa = s_x1 + (u & 1) * FULL_SLICE_BUF;  // x1 rows
      const float* xb = xa + FULL_ROWS * X_SLICE_LD;       // the stage's x2 rows
#pragma unroll 2
      for (int k = 0; k < X_SLICE; k += 4) {
        float4 a4[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a4[i][h] = *reinterpret_cast<const float4*>(xa + (wrow + 16 * i + gid + 8 * h) *
                                                                 X_SLICE_LD + k);
#pragma unroll
        for (int q = 0; q < KS; ++q)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float4 b4 = *reinterpret_cast<const float4*>(
                xb + (8 * (kg * KS + q) + tig + 4 * cc) * X_SLICE_LD + k);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) sq_add4(sq[q][i][h + 2 * cc], a4[i][h], b4);
          }
      }
      if (c + 1 < nsl) continue;

      // the stage's entries and MMAs, as the full-width layout runs them
      const float4* vt = reinterpret_cast<const float4*>(s_v + (t & 1) * VSTAGE);
#pragma unroll
      for (int q = 0; q < KS; q += 2) {
        const int s0 = kg * KS + q;
        unsigned ahi[2][MT][4], alo[2][MT][4];
#pragma unroll
        for (int u2 = 0; u2 < 2; ++u2)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const float ent =
                  leaf_entry<LEAF>(sq[q + u2][i][f], s_prog, s_coef, a.n_instr, a.need_l2);
              ahi[u2][i][f] = tf32_rna(ent);
              alo[u2][i][f] = tf32_rna(ent - __uint_as_float(ahi[u2][i][f]));
            }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float part[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
          for (int u2 = 0; u2 < 2; ++u2) {
            const float4 b = vt[((s0 + u2) * NT + j) * 32 + lane];
            const unsigned bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
            const unsigned bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], alo[u2][i], bh0, bh1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], ahi[u2][i], bl0, bl1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], ahi[u2][i], bh0, bh1);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][e];
        }
      }
    }
  } else {
    stage(0, 0);
    for (int t = 0; t < stages; ++t) {
      cp_async_wait_all();
      __syncthreads();  // stage t is in place; every warp is done with stage t - 1
      if (t + 1 < stages) stage(t + 1, (t + 1) & 1);
      const float* x2t = s_x2 + (t & 1) * FULL_STAGE * dx;
      const float4* vt = reinterpret_cast<const float4*>(s_v + (t & 1) * VSTAGE);

      // the k-half's k-steps two at a time: per tile of the pass, lo hi and
      // hi lo, then hi hi, of both into a zeroed partial, which a rounded fp32
      // add takes into the sum
#pragma unroll 1
      for (int q = 0; q < KS; q += 2) {
        const int s0 = kg * KS + q;
        unsigned ahi[2][MT][4], alo[2][MT][4];
        fragments(x2t, s0, ahi[0], alo[0]);
        fragments(x2t, s0 + 1, ahi[1], alo[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float part[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float4 b = vt[((s0 + u) * NT + j) * 32 + lane];
            const unsigned bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
            const unsigned bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], alo[u][i], bh0, bh1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], ahi[u][i], bl0, bl1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(part[i], ahi[u][i], bh0, bh1);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][e];
        }
      }
    }
  }

  // the k-halves of a row group: the second writes its sums into the stage
  // buffers, the first adds them in
  __syncthreads();  // every warp is done with the stage buffers
  float* s_red = s_v;
  if (kg > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_red[(((rg * MT + i) * NT + j) * 4 + e) * 32 + lane] = acc[i][j][e];
  }
  __syncthreads();
  if (kg > 0) return;

  // c0, c1: row gid, columns 2 tig and 2 tig + 1; c2, c3: row gid + 8
  const int col0 = pass * NT * 8;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wrow + 16 * i + gid + 8 * (e >> 1);
        const int col = col0 + 8 * j + 2 * tig + (e & 1);
        const float sum = acc[i][j][e] + s_red[(((rg * MT + i) * NT + j) * 4 + e) * 32 + lane];
        if (row < n && col < a.r) a.out[(size_t)row * a.r + col] = amp * sum;
      }
}

// One instantiation's launch: grid (128-row blocks, passes).
template <int NT, int D, int LEAF>
cudaError_t full_launch_one(const FullArgs& a, int passes, cudaStream_t st) {
  const size_t smem = sizeof(float) * full_smem_floats<D>(a.d, a.dx, a.nt);
  cudaError_t err = prepare(matvec_full_tc_kernel<NT, D, LEAF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.n + FULL_ROWS - 1) / FULL_ROWS), (unsigned)passes);
  matvec_full_tc_kernel<NT, D, LEAF><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The pass's tiles of 8 columns, one of kernel_ops.FULL_TILES (acc holds
// 8 NT floats a thread).
template <int LEAF, int D>
cudaError_t full_launch_d(const FullArgs& a, int passes, cudaStream_t st) {
  switch (a.nt) {
    case 1: return full_launch_one<1, D, LEAF>(a, passes, st);
    case 2: return full_launch_one<2, D, LEAF>(a, passes, st);
    case 3: return full_launch_one<3, D, LEAF>(a, passes, st);
    case 4: return full_launch_one<4, D, LEAF>(a, passes, st);
    case 5: return full_launch_one<5, D, LEAF>(a, passes, st);
    case 6: return full_launch_one<6, D, LEAF>(a, passes, st);
    case 8: return full_launch_one<8, D, LEAF>(a, passes, st);
    case 9: return full_launch_one<9, D, LEAF>(a, passes, st);
    case 12: return full_launch_one<12, D, LEAF>(a, passes, st);
    case 16: return full_launch_one<16, D, LEAF>(a, passes, st);
    default: return cudaErrorInvalidValue;
  }
}

// A compiled leaf at x width D (4 or 8; the sliced layout is
// gm_full_launch_sliced).
template <int LEAF>
cudaError_t full_launch_leaf(const FullArgs& a, int passes, int D, cudaStream_t st) {
  switch (D) {
    case 4: return full_launch_d<LEAF, 4>(a, passes, st);
    case 8: return gm_full_launch_d8(a, LEAF, passes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The Matern instantiations (gram_matvec_full_matern.cu).
cudaError_t gm_full_launch_matern(const FullArgs& a, int leaf, int passes, int D,
                                  cudaStream_t st);
// The sliced layout's instantiations: the interpreter and RBF
// (gram_matvec_full_sliced.cu), the Materns (gram_matvec_full_sliced_matern.cu).
cudaError_t gm_full_launch_sliced(const FullArgs& a, int leaf, int passes, cudaStream_t st);
cudaError_t gm_full_launch_sliced_matern(const FullArgs& a, int leaf, int passes,
                                         cudaStream_t st);
