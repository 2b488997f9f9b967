// K3, the same-set matvec out = K(x, x) @ V from the upper-triangle tiles,
// for NVIDIA Hopper (sm_90a). Replaces _matvec_fwd_sym_impl of the JAX
// package's ops/pallas/kernel_ops.py. The kernel template lives here so that
// its instantiations can be compiled in several sources at once:
// gram_matvec_sym.cu (the interpreted trees and RBF, the launcher and the
// finishing pass), gram_matvec_sym_matern.cu (the Matern family) and
// gram_matvec_sym_sliced.cu (the sliced layout, every route).
//
// What bounds it on this card. At n = 102400 the sweep evaluates
// n (n + 1) / 2 ~ 5.2e9 entries (one exponential each) and applies each
// entry twice, 2 R FMAs an entry for R columns. The floors are the SFU
// (1.25 ms of exponentials) and the fp32 pipe (1.5 ms at r = 1, 4 ms at
// r = 9); x and V are a few MB and stay in L2. What costs is issue slots:
// the product, the per-tile reductions and flushes, and any fixed cost
// paid per tile rather than per block.
//
// What the design does about it:
//   * A product that follows r. A pass holds R = 1, 2, 4, 8 or 16 columns,
//     the next power of two at or above r (r = 1 does 2 FMAs an entry, not
//     32); a wider V is cut into passes of 16 columns (blockIdx.y).
//   * Entries kept in registers. Each thread owns 4 rows x 4 columns of a
//     64 x 64 tile: its rows are ty + 16 i (ty = lane & 15), its columns
//     4 tx + j of its warp's 8 (tx = lane >> 4). It evaluates its 16
//     entries into registers and applies them at once to out_i (with V_j)
//     and to out_j (with V_i). For out_j, a pass of
//     R <= 4 columns sums its 4 R partials over its 4 rows and the 16 lanes
//     of its column lane combine them by a butterfly reduce-scatter of warp
//     shuffles; a wider pass writes the warp's 64 x 8 entries to shared
//     rows of its own, and each lane sums one column over 16 rows, so 4
//     lanes, not 16, share a column and the shuffles fall from about 4 R to
//     R. Both are fixed orders.
//   * Blocks that walk a strip. A block takes one work item, a segment
//     (ti, j0, j1) of row strip ti, and walks its tiles in ascending j. The
//     host builds the items (ops/cuda/kernel_ops.py, sym_schedule): strips
//     i and p - 1 - i are paired, so every pair holds p + 1 tiles, and
//     pairs are cut into equal segments, enough of them to fill the card at
//     every n the dispatch rule sends here. out_i's partial stays in
//     registers over the whole segment and is flushed once; out_j is
//     flushed per tile. The program, the coefficients, x_i and V_i are
//     loaded once per item. Each warp stages its own 8 columns' x_j and V_j
//     in a double buffer of its own, prefetched into registers a tile
//     ahead, so the walk takes no block-wide barrier.
//   * Leaves fixed at compile time (gram_matvec_common.cuh, shared with
//     K2). A tree of one RBF or Matern leaf is an
//     instantiation (LEAF = its opcode): x is prescaled so that the squared
//     distance already carries the leaf's coefficient (RBF then costs the
//     SFU's ex2 alone), and the amplitude is applied once to each partial
//     sum, not to each entry; x is held in
//     registers at a padded width D = 2, 4 or 8 (zero coordinates add
//     nothing to a squared distance). Every other tree takes LEAF = 0, the
//     postfix interpreter of gram_matvec_common.cuh, with x_i and the warps'
//     x_j at full width in shared memory and d read in a loop (D = 0), up
//     to d = 8. The wrapper picks the route and the layout before the
//     launch.
//   * Any d (D = X_SLICED, gram_matvec_slice.cuh): above those widths, x is
//     prescaled into a copy padded to whole slices, and for each tile the
//     block stages 32 coordinates of x_i and x_j a step (cp.async,
//     double-buffered, one block barrier a step); a thread sums its 4 x 4
//     squared distances in registers across the slices, then evaluates
//     and applies them as above. Shared memory does not grow with d, and
//     the warps' buffers hold V_j only. Against D = 0 it measured 1.5%
//     slower at d = 9 and 13x faster at d = 64 (PERF.md), so it takes every
//     d past the compiled widths and, for the interpreter, past d = 8.
//   * Equal bits on every run. Blocks run in no order, so each fp32 partial
//     is rounded to a 64-bit fixed-point integer and added with an integer
//     atomicAdd, which is associative. Column c has its own scale 2^e_c,
//     chosen by the wrapper (sym_fixed_point_scales) so that
//     k(0) sum_j |V[j, c]| 2^e_c <= 2^61. Every tree the wrapper encodes is
//     a white-free stationary positive-definite kernel, |k(r)| <= k(0), so
//     out[i, c] and every partial sum of its terms are at most
//     k(0) sum_j |V[j, c]| in magnitude. A partial now sums up to n fp32
//     terms (a whole segment of out_i), whose rounding adds at most about
//     n 2^-24 of that bound (0.6% at n = 102400), far inside the factor 4
//     left below 2^63: no sum can overflow. The scale is applied in double,
//     where 2^e_c and acc 2^e_c are exact. Intermediate sums may wrap
//     around as unsigned integers; the wraparound cancels exactly.
//   * NaN and Inf: a non-finite partial sets its column's flag with
//     atomicOr; the wrapper flags a column whose bound is not finite; the
//     finishing pass writes NaN into a flagged column.

#pragma once

#include "gram_matvec_slice.cuh"

// What one launch of the sweep reads and writes (device pointers).
struct SymArgs {
  const float* x;
  const float* v;
  unsigned long long* sum;
  unsigned int* flag;
  const double* scale;
  const int* items;  // (ti, j0, j1) per work item
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int n, d, r, need_l2;
  const float* xs;  // sliced layout: x prescaled, 64-row tiles x dp, zero past d
  int dp;
};

namespace {

constexpr int SYM_R_MAX = 16;      // columns of V per pass
constexpr int SYM_WARPS = THREADS / 32;
constexpr int SYM_WCOLS = 8;       // tile columns per warp: 2 column lanes x 4
constexpr int SYM_LDK = 12;        // padded row of a warp's 64 x 8 entries (R >= 8)

// padded row of V in shared memory: conflict-free 16-byte reads by 8 rows
template <int R>
__host__ __device__ constexpr int sym_ldv() {
  return R >= 8 ? R + 4 : R;
}

template <int N>
__host__ __device__ constexpr int ilog2() {
  return N <= 1 ? 0 : 1 + ilog2<N / 2>();
}

// Shared memory of one block, in floats: the scales (as doubles), the
// program, V_i, the out_i reduction, the warps' entries (R >= 8), x_i
// (D = 0; two steps' slices of x_i and x_j in the sliced layout) and the
// warps' double buffers of x_j (none in the sliced layout) and V_j.
template <int R, int D>
__host__ __device__ inline size_t sym_smem_floats(int d) {
  constexpr int LDV = sym_ldv<R>();
  const int dx = D > 0 ? D : D == 0 ? d : 0;
  return (size_t)2 * SYM_R_MAX + MAX_COEF + 2 * MAX_INSTR + TILE * LDV +
         SYM_WARPS * TILE * R + (R >= 8 ? SYM_WARPS * TILE * SYM_LDK : 0) +
         (D > 0 ? 0 : D == 0 ? TILE * d : 4 * TILE * X_SLICE_LD) +
         (size_t)SYM_WARPS * 2 * SYM_WCOLS * (LDV + dx);
}

// R consecutive floats of shared memory into registers (16-byte reads
// where R allows; rows are 16-byte aligned).
template <int R>
__device__ __forceinline__ void sym_row(float (&dst)[R], const float* src) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = t.x;
      dst[4 * q + 1] = t.y;
      dst[4 * q + 2] = t.z;
      dst[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < R; ++c) dst[c] = src[c];
  }
}

// Butterfly reduce-scatter of v[0, L) over the lanes that differ only in
// the bits OFF, OFF / 2, ..., LAST of the lane index, in that order. While
// more than one value is left, a lane keeps half (the upper half where its
// bit is set) and adds its partner's copy of that half; then it adds its
// partner's value. Over the 16 lanes of bits 8..1, lane ty = lane & 15
// ends with the sum of [ty L / 16, (ty + 1) L / 16) for L >= 16, else of
// entry ty >> (4 - log2 L) (lanes that differ in the low bits hold the
// same sum); over the 4 lanes of bits 16, 8, lane g = lane >> 3 ends with
// [g L / 4, (g + 1) L / 4). Every sum is formed in one order, so the bits
// do not depend on timing.
template <int L, int OFF, int LAST>
__device__ __forceinline__ void sym_reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= LAST) {
    if constexpr (L >= 2) {
      constexpr int H = L / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      sym_reduce_scatter<H, OFF / 2, LAST>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      sym_reduce_scatter<1, OFF / 2, LAST>(v, lane);
    }
  }
}

// One contribution into the fixed-point sums: round(val 2^e_col) with an
// integer atomicAdd; a non-finite partial flags its column.
__device__ __forceinline__ void sym_fixed_add(unsigned long long* sum, unsigned int* flag,
                                              size_t idx, int col, float val, double s) {
  if (!isfinite(val)) atomicOr(flag + col, 1u);
  atomicAdd(sum + idx, (unsigned long long)__double2ll_rn((double)val * s));
}

template <int R, int D, int LEAF>
__global__ void __launch_bounds__(THREADS) matvec_sym_kernel(SymArgs a) {
  constexpr int LDV = sym_ldv<R>();
  constexpr int PV = (SYM_WCOLS * R + 31) / 32; // V_j values a lane prefetches
  constexpr int PX = D > 0 ? (SYM_WCOLS * D + 31) / 32 : 1;
  const int n = a.n, d = a.d, r = a.r;
  const int dx = D > 0 ? D : D == 0 ? d : 0;   // x_j's width in the buffers
  const int wstride = SYM_WCOLS * (LDV + dx);   // one buffer of a warp

  extern __shared__ __align__(16) float smem[];
  double* s_scale = reinterpret_cast<double*>(smem);
  float* s_coef = smem + 2 * SYM_R_MAX;
  int* s_prog = reinterpret_cast<int*>(s_coef + MAX_COEF);
  float* s_vi = s_coef + MAX_COEF + 2 * MAX_INSTR;  // TILE x LDV
  float* s_red = s_vi + TILE * LDV;                 // warps x TILE x R
  float* s_ks = s_red + SYM_WARPS * TILE * R;       // warps x TILE x SYM_LDK (R >= 8)
  float* s_xi = s_ks + (R >= 8 ? SYM_WARPS * TILE * SYM_LDK : 0);  // TILE x d (D = 0)
  // warps x 2 x (8 LDV + 8 dx), after x_i (D = 0) or two steps' slices
  float* s_wb = s_xi + (D > 0 ? 0 : D == 0 ? TILE * d : 4 * TILE * X_SLICE_LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane & 15, tx = lane >> 4;
  const int ti = a.items[3 * blockIdx.x];
  const int j0 = a.items[3 * blockIdx.x + 1], j1 = a.items[3 * blockIdx.x + 2];
  const int c0 = blockIdx.y * R;
  const int row_i = ti * TILE;
  const int wcol = warp * SYM_WCOLS;  // the warp's first column in a tile

  if constexpr (LEAF == 0) load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
  for (int c = threadIdx.x; c < R; c += THREADS)
    s_scale[c] = c0 + c < r ? a.scale[c0 + c] : 1.0;
  for (int e = threadIdx.x; e < TILE * R; e += THREADS) {
    const int rr = e / R, c = e % R;
    const int row = row_i + rr, col = c0 + c;
    s_vi[rr * LDV + c] = (row < n && col < r) ? a.v[(size_t)row * r + col] : 0.0f;
  }
  float amp, xs;  // the leaf's amplitude (applied to partial sums), x's scale
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);
  if constexpr (D == 0) {
    load_x(s_xi, a.x, row_i, n, d, false);
    for (int e = threadIdx.x; e < TILE * d; e += THREADS) s_xi[e] *= xs;  // this thread's own
  }
  float xi[4][D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row_i + ty + 16 * i;
#pragma unroll
      for (int k = 0; k < D; ++k)
        xi[i][k] = (row < n && k < d) ? xs * a.x[(size_t)row * d + k] : 0.0f;
    }
  }

  // the warp's x_j and V_j of tile j: V rows first (16-byte aligned)
  float* wb = s_wb + warp * 2 * wstride;
  float pv[PV], px[PX];
  auto fetch = [&](int j) {
    const int row0 = j * TILE + wcol;
#pragma unroll
    for (int q = 0; q < PV; ++q) {
      const int e = lane + 32 * q;
      const int col = e / R, c = e % R;
      const int row = row0 + col;
      pv[q] = (e < SYM_WCOLS * R && row < n && c0 + c < r) ? a.v[(size_t)row * r + c0 + c]
                                                            : 0.0f;
    }
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int e = lane + 32 * q;
        const int col = e / D, k = e % D;
        const int row = row0 + col;
        px[q] = (e < SYM_WCOLS * D && row < n && k < d) ? xs * a.x[(size_t)row * d + k] : 0.0f;
      }
    }
  };
  auto stash = [&](int j, float* buf) {
#pragma unroll
    for (int q = 0; q < PV; ++q) {
      const int e = lane + 32 * q;
      if (e < SYM_WCOLS * R) buf[(e / R) * LDV + e % R] = pv[q];
    }
    float* bx = buf + SYM_WCOLS * LDV;
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int e = lane + 32 * q;
        if (e < SYM_WCOLS * D) bx[e] = px[q];
      }
    } else if constexpr (D == 0) {
      const int row0 = j * TILE + wcol;
      for (int e = lane; e < SYM_WCOLS * d; e += 32) {
        const int row = row0 + e / d;
        bx[e] = row < n ? xs * a.x[(size_t)row * d + e % d] : 0.0f;
      }
    }
  };
  fetch(j0);
  stash(j0, wb);
  __syncthreads();  // V_i, x_i, the program and the first buffers are in place

  // the sliced layout: slice c of tile j is step (j - j0) nsl + c, x_i's
  // and x_j's rows
  const int nsl = D == X_SLICED ? a.dp / X_SLICE : 0, steps = (j1 - j0) * nsl;
  auto issue = [&](int u) {
    const int jt = j0 + u / nsl, cs = u % nsl;
    slice_rows<TILE, TILE>(s_xi + (u & 1) * 2 * TILE * X_SLICE_LD, a.xs, row_i, a.xs,
                           jt * TILE, a.dp, cs * X_SLICE);
    cp_async_commit();
  };
  if constexpr (D == X_SLICED) issue(0);

  float acc[4][R];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[i][c] = 0.0f;

  for (int j = j0; j < j1; ++j) {
    const float* cur = wb + ((j - j0) & 1) * wstride;
    if (j + 1 < j1) fetch(j + 1);

    // the lane's 16 entries: rows ty + 16 i, columns wcol + 4 tx + jj
    float kv[4][4];
    if constexpr (D == X_SLICED) {
      float sq[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sq[i][jj] = 0.0f;
      for (int c = 0; c < nsl; ++c) {
        const int u = (j - j0) * nsl + c;
        cp_async_wait_all();
        __syncthreads();  // step u is in place; every warp is done with step u - 1
        if (u + 1 < steps) issue(u + 1);
        const float* xa = s_xi + (u & 1) * 2 * TILE * X_SLICE_LD;  // x_i
        const float* xb = xa + TILE * X_SLICE_LD;                   // x_j
#pragma unroll 2
        for (int k = 0; k < X_SLICE; k += 4) {
          float4 a4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a4[i] = *reinterpret_cast<const float4*>(xa + (ty + 16 * i) * X_SLICE_LD + k);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(xb + (wcol + 4 * tx + jj) * X_SLICE_LD + k);
#pragma unroll
            for (int i = 0; i < 4; ++i) sq_add4(sq[i][jj], a4[i], b4);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kv[i][jj] = leaf_entry<LEAF>(sq[i][jj], s_prog, s_coef, a.n_instr, a.need_l2);
    } else {
      const float* xs = cur + SYM_WCOLS * LDV;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* xb = xs + (4 * tx + jj) * dx;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sq = 0.0f;
          if constexpr (D > 0) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const float t = xi[i][k] - xb[k];
              sq = fmaf(t, t, sq);
            }
          } else {
            const float* xa = s_xi + (ty + 16 * i) * d;
            for (int k = 0; k < d; ++k) {
              const float t = xa[k] - xb[k];
              sq = fmaf(t, t, sq);
            }
          }
          kv[i][jj] = leaf_entry<LEAF>(sq, s_prog, s_coef, a.n_instr, a.need_l2);
        }
      }
    }

    // out_i += T V_j, kept in registers over the segment
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vj[R];
      sym_row<R>(vj, cur + (4 * tx + jj) * LDV);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[i][c] = fmaf(kv[i][jj], vj[c], acc[i][c]);
    }

    // out_j += T^T V_i off the diagonal, flushed per tile
    if (j != ti) {
      if constexpr (R >= 8) {
        // the warp's 64 x 8 entries through its own shared rows: lane
        // (g, b) = (lane >> 3, lane & 7) sums column b over rows g + 4 m,
        // then the 4 lanes of column b reduce-scatter its R sums
        float* ks = s_ks + warp * TILE * SYM_LDK;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(ks + (ty + 16 * i) * SYM_LDK + 4 * tx) =
              make_float4(kv[i][0], kv[i][1], kv[i][2], kv[i][3]);
        __syncwarp();
        const int g = lane >> 3, b = lane & 7;
        float pj[R];
#pragma unroll
        for (int c = 0; c < R; ++c) pj[c] = 0.0f;
#pragma unroll
        for (int m = 0; m < TILE / 4; ++m) {
          const int rr = g + 4 * m;
          const float kb = ks[rr * SYM_LDK + b];
          float vi[R];
          sym_row<R>(vi, s_vi + rr * LDV);
#pragma unroll
          for (int c = 0; c < R; ++c) pj[c] = fmaf(kb, vi[c], pj[c]);
        }
        sym_reduce_scatter<R, 16, 8>(pj, lane);
        const int row = j * TILE + wcol + b;
#pragma unroll
        for (int o = 0; o < R / 4; ++o) {
          const int c = g * (R / 4) + o, col = c0 + c;
          if (row < n && col < r)
            sym_fixed_add(a.sum, a.flag, (size_t)row * r + col, col, amp * pj[o], s_scale[c]);
        }
      } else {
        // lane (ty, tx) sums its 4 columns over its 4 rows; the 16 lanes of
        // column lane tx reduce-scatter the 4 R sums
        constexpr int N = 4 * R;
        constexpr int OUT = N >= 16 ? N / 16 : 1;
        float pj[N];
#pragma unroll
        for (int k = 0; k < N; ++k) pj[k] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float vi[R];
          sym_row<R>(vi, s_vi + (ty + 16 * i) * LDV);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int c = 0; c < R; ++c) pj[jj * R + c] = fmaf(kv[i][jj], vi[c], pj[jj * R + c]);
        }
        sym_reduce_scatter<N, 8, 1>(pj, lane);
        const bool writer = N >= 16 || (ty & (16 / N - 1)) == 0;
        const int base = N >= 16 ? ty * OUT : ty >> (4 - ilog2<N>());
        if (writer) {
#pragma unroll
          for (int o = 0; o < OUT; ++o) {
            const int idx = base + o, jj = idx / R, c = idx % R;
            const int row = j * TILE + wcol + 4 * tx + jj, col = c0 + c;
            if (row < n && col < r)
              sym_fixed_add(a.sum, a.flag, (size_t)row * r + col, col, amp * pj[o],
                            s_scale[c]);
          }
        }
      }
    }

    if (j + 1 < j1) stash(j + 1, wb + ((j + 1 - j0) & 1) * wstride);
    __syncwarp();
  }

  // out_i: add the two column lanes, then the warps in order, and flush once
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) s_red[(warp * TILE + ty + 16 * i) * R + c] = acc[i][c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * R; e += THREADS) {
    const int rr = e / R, c = e % R;
    float t = s_red[e];
#pragma unroll
    for (int w = 1; w < SYM_WARPS; ++w) t += s_red[w * TILE * R + e];
    const int row = row_i + rr, col = c0 + c;
    if (row < n && col < r)
      sym_fixed_add(a.sum, a.flag, (size_t)row * r + col, col, amp * t, s_scale[c]);
  }
}

// One instantiation's launch: grid (items, passes of R columns).
template <int R, int D, int LEAF>
cudaError_t sym_launch_one(const SymArgs& a, int n_items, cudaStream_t st) {
  const size_t smem = sizeof(float) * sym_smem_floats<R, D>(a.d);
  cudaError_t err = prepare(matvec_sym_kernel<R, D, LEAF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_items, (unsigned)((a.r + R - 1) / R));
  matvec_sym_kernel<R, D, LEAF><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int LEAF, int D>
cudaError_t sym_launch_d(const SymArgs& a, int R, int n_items, cudaStream_t st) {
  switch (R) {
    case 1: return sym_launch_one<1, D, LEAF>(a, n_items, st);
    case 2: return sym_launch_one<2, D, LEAF>(a, n_items, st);
    case 4: return sym_launch_one<4, D, LEAF>(a, n_items, st);
    case 8: return sym_launch_one<8, D, LEAF>(a, n_items, st);
    case 16: return sym_launch_one<16, D, LEAF>(a, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}

// A compiled leaf at x width D (2, 4 or 8; the sliced layout is
// gm_sym_launch_sliced).
template <int LEAF>
cudaError_t sym_launch_leaf(const SymArgs& a, int R, int D, int n_items, cudaStream_t st) {
  switch (D) {
    case 2: return sym_launch_d<LEAF, 2>(a, R, n_items, st);
    case 4: return sym_launch_d<LEAF, 4>(a, R, n_items, st);
    case 8: return sym_launch_d<LEAF, 8>(a, R, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The Matern instantiations (gram_matvec_sym_matern.cu).
cudaError_t gm_sym_launch_matern(const SymArgs& a, int leaf, int R, int D, int n_items,
                                 cudaStream_t st);
// Every route's sliced instantiations (gram_matvec_sym_sliced.cu).
cudaError_t gm_sym_launch_sliced(const SymArgs& a, int leaf, int R, int n_items,
                                 cudaStream_t st);
