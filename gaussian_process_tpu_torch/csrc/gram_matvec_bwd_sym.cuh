// K4's symmetric backward sweep for NVIDIA Hopper (sm_90a): for
// L = <ct, K(x, x) V>, dL/dcoef (the gradient in the coefficient vector of
// the kernel's postfix program) from the upper-triangle tiles, without
// dL/dx: a training step's backward. Replaces _matvec_bwd_sweep of the JAX
// package's ops/pallas/kernel_ops.py on that path; the full sweep
// (gram_matvec_bwd.cuh) keeps cross-set calls and those that want dx. The
// kernel template lives here so that its instantiations can be compiled in
// several sources at once: gram_matvec_bwd_sym.cu (the interpreted trees,
// RBF and the launcher) and gram_matvec_bwd_sym_matern.cu (the Matern
// family).
//
// What it computes. With G = ct V^T, dL/dcoef = sum_ij G_ij dk_ij/dcoef.
// k_ij = k_ji, so the sum runs over the pairs of the upper triangle with the
// pair weight
//   w_ij = G_ij + G_ji = [ct_i | v_i] . [v_j | ct_j]    (a dot of length 2r);
// on a diagonal tile every entry of the 64 x 64 tile takes w_ij / 2, which is
// the exact diagonal sum, with no branch.
//
// What bounds it on this card. At n = 102400 the sweep evaluates
// n (n + 1) / 2 ~ 5.2e9 pairs: its squared distance (3d operations), one
// exponential, a 2R-term pair weight and the leaf's few coefficient terms,
// about 12 + 2R fp32 instructions a pair for the compiled RBF at d = 4, near
// 5 ms of the fp32 pipe at r = 9 (the SFU's floor is 1.25 ms). x, V and ct
// are a few MB and stay in L2. The full sweep (gram_matvec_bwd.cuh)
// evaluates all n^2 entries, each once, with G from registers or the tensor
// cores; this one halves the entries and pays 2R FMAs a pair for the
// weight.
//
// What the design does about it (K3's design, gram_matvec_sym.cuh):
//   * Blocks walk strips. A block takes one work item (ti, j0, j1) of
//     kernel_ops.sym_schedule and walks its tiles in ascending j. Its rows'
//     [ct_i | v_i] and x_i are loaded once per item, into registers. Each
//     warp stages its 8 columns' [v_j | ct_j] and x_j in a double buffer of
//     its own, prefetched into registers a tile ahead, so the walk takes no
//     block-wide barrier.
//   * Entries in registers. Each thread owns 4 rows x 4 columns of a tile
//     (rows ty + 16 i, ty = lane & 15; columns 4 tx + jj of its warp's 8,
//     tx = lane >> 4), evaluates each entry once and multiplies it by its
//     pair weight.
//   * A pair product that follows r. A pass holds R = 1, 2, 4, 6, 9, 12 or
//     16 columns of V and ct (kernel_ops.bwd_sym_passes), so a pair costs
//     2R FMAs; a wider V is cut into passes (blockIdx.y), whose partials
//     add, since dL/dcoef is linear in the columns.
//   * Compiled leaves. A tree of one RBF or Matern leaf is an instantiation
//     (LEAF = its opcode) on x prescaled by leaf_x_scale, as in the forward
//     sweeps. It sums only what the two coefficient derivatives need, in the
//     prescaled distance sq': S0 = sum w f and S1 = sum w h, with RBF
//     f = 2^-sq', h = f sq', and a Matern's s = sqrt(sq'), f = p(s) e^-s,
//     h = (p'(s) - p(s)) s e^-s (leaf_bwd_terms, shared with the tile
//     gram's backward, gram_bwd.cu). The wrapper turns them into dL/dc0 = S0 and
//     dL/dc1 = c0 S1 / (-c1 log2 e) (RBF) or c0 S1 / c1 (Matern)
//     (kernel_ops.bwd_sym_coef). x is held in registers at a padded width
//     D = 4 or 8. Every other tree takes LEAF = 0, tree_grad's interpreter
//     (gram_matvec_common.cuh), with x_i and the warps' x_j buffers at width
//     d in shared memory and d read in a loop (D = 0), up to d = 8.
//   * Any d (D = X_SLICED, gram_matvec_slice.cuh), as in K3: past those
//     widths the block stages 32 coordinates of x_i and x_j of a tile a
//     step from a prescaled padded copy (cp.async, double-buffered); a
//     thread sums its 4 x 4 squared distances in registers across the
//     slices, then weighs them in D = 0's order. The warps' buffers then
//     hold [v_j | ct_j] only. Against D = 0 it measured 2.1x faster at
//     d = 9 and 16x at d = 64 (PERF.md).
//   * Equal bits on every run. A thread sums its coefficient terms in fp32
//     over a tile, then in float64 over the item; the block reduces its
//     threads in a fixed order and writes one float64 partial per work item,
//     pass and sum, with no atomics; the wrapper sums the partials in a
//     fixed order.

#pragma once

#include "gram_matvec_slice.cuh"

// What one launch of the sweep reads and writes (device pointers).
struct BwdSymArgs {
  const float* x;
  const float* v;
  const float* ct;
  double* part;      // (passes x items) x the route's sums
  const int* items;  // (ti, j0, j1) per work item
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int n, d, r, need_l2;
  const float* xs;   // sliced layout: x prescaled, 64-row tiles x dp, zero past d
  int dp;
};

namespace {

constexpr int BS_WARPS = THREADS / 32;
constexpr int BS_WCOLS = 8;  // tile columns per warp: 2 column lanes x 4

// The padded row of [v_j | ct_j] (2R floats) in a warp's buffer: a multiple
// of 4 floats (16-byte reads) that is not a multiple of 8, so that the two
// column lanes, whose columns lie 4 rows apart, read other banks.
template <int R>
__host__ __device__ constexpr int bs_ldb() {
  return (2 * R + 3) / 4 * 4 + (((2 * R + 3) / 4) % 2 == 0 ? 4 : 0);
}

// The float64 sums a block writes: S0 and S1 for a compiled leaf, one per
// coefficient for the interpreter.
template <int LEAF>
__host__ __device__ constexpr int bs_sums() {
  return LEAF == 0 ? MAX_BWD_COEF : 2;
}

// Shared memory of one block, in floats: the block's reduction (as
// doubles), the program and its operand table, x_i (D = 0; two steps'
// slices of x_i and x_j in the sliced layout) and the warps' double buffers
// of [v_j | ct_j] and x_j (none in the sliced layout).
template <int R, int D>
__host__ __device__ inline size_t bs_smem_floats(int d) {
  const int dx = D > 0 ? D : D == 0 ? d : 0;
  return (size_t)2 * BS_WARPS * MAX_BWD_COEF + MAX_BWD_COEF + 4 * MAX_BWD_INSTR +
         (D > 0 ? 0 : D == 0 ? TILE * d : 4 * TILE * X_SLICE_LD) +
         (size_t)BS_WARPS * 2 * BS_WCOLS * (bs_ldb<R>() + dx);
}

// w[i] = a[i] . b for the thread's 4 rows; b, P floats (P even) in shared
// memory, read 16 bytes at a time.
template <int P>
__device__ __forceinline__ void bs_pair_weights(float (&w)[4], const float (&a)[4][P],
                                                const float* b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0.0f;
#pragma unroll
  for (int c = 0; c + 4 <= P; c += 4) {
    const float4 t = *reinterpret_cast<const float4*>(b + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = fmaf(a[i][c], t.x, w[i]);
      w[i] = fmaf(a[i][c + 1], t.y, w[i]);
      w[i] = fmaf(a[i][c + 2], t.z, w[i]);
      w[i] = fmaf(a[i][c + 3], t.w, w[i]);
    }
  }
  if constexpr (P % 4 == 2) {
    const float2 t = *reinterpret_cast<const float2*>(b + P - 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = fmaf(a[i][P - 2], t.x, w[i]);
      w[i] = fmaf(a[i][P - 1], t.y, w[i]);
    }
  }
}

// One entry's terms, its pair weight w times the derivatives the route
// sums (the header's S0, S1; the interpreter's dk/dcoef), into the tile's
// fp32 sums t.
template <int LEAF>
__device__ __forceinline__ void bs_entry(float sq, float w, float (&t)[bs_sums<LEAF>()],
                                         const int* prog, const int* kid, const float* coef,
                                         int n_instr, int need_l2) {
  if constexpr (LEAF == 0) {
    tree_grad(prog, kid, coef, n_instr, sq, need_l2 ? sqrtf(sq) : 0.0f, w, t);
  } else {
    float unused;
    leaf_bwd_terms<LEAF, false>(sq, w, t[0], t[1], unused);
  }
}

template <int R, int D, int LEAF>
__global__ void __launch_bounds__(THREADS) matvec_bwd_sym_kernel(BwdSymArgs a) {
  constexpr int P = 2 * R;                         // the pair product's length
  constexpr int LDB = bs_ldb<R>();
  constexpr int NS = bs_sums<LEAF>();
  constexpr int PB = (BS_WCOLS * P + 31) / 32;     // [v_j | ct_j] values a lane prefetches
  constexpr int PX = D > 0 ? (BS_WCOLS * D + 31) / 32 : 1;
  const int n = a.n, d = a.d, r = a.r;
  const int dx = D > 0 ? D : D == 0 ? d : 0;       // x_j's width in the buffers
  const int wstride = BS_WCOLS * (LDB + dx);       // one buffer of a warp

  extern __shared__ __align__(16) float smem[];
  double* s_red = reinterpret_cast<double*>(smem);                       // warps x NS
  float* s_coef = smem + 2 * BS_WARPS * MAX_BWD_COEF;                    // MAX_BWD_COEF
  int* s_prog = reinterpret_cast<int*>(s_coef + MAX_BWD_COEF);           // 2 MAX_BWD_INSTR
  int* s_kid = s_prog + 2 * MAX_BWD_INSTR;                               // 2 MAX_BWD_INSTR
  float* s_xi = reinterpret_cast<float*>(s_kid + 2 * MAX_BWD_INSTR);     // TILE x d (D = 0)
  // warps x 2 x (8 LDB + 8 dx), after x_i (D = 0) or two steps' slices
  float* s_wb = s_xi + (D > 0 ? 0 : D == 0 ? TILE * d : 4 * TILE * X_SLICE_LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane & 15, tx = lane >> 4;
  const int ti = a.items[3 * blockIdx.x];
  const int j0 = a.items[3 * blockIdx.x + 1], j1 = a.items[3 * blockIdx.x + 2];
  const int c0 = blockIdx.y * R;
  const int row_i = ti * TILE;
  const int wcol = warp * BS_WCOLS;  // the warp's first column in a tile

  if constexpr (LEAF == 0) load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
  float amp, xs;  // x's scale; the wrapper applies the amplitude
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);
  if constexpr (D == 0) {
    load_x(s_xi, a.x, row_i, n, d, false);
    for (int e = threadIdx.x; e < TILE * d; e += THREADS) s_xi[e] *= xs;  // this thread's own
  }

  // the thread's 4 rows: [ct_i | v_i] and x_i, zero past the edges
  float ai[4][P];
  float xi[4][D > 0 ? D : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row_i + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const bool ok = row < n && c0 + c < r;
      const size_t idx = (size_t)row * r + c0 + c;
      ai[i][c] = ok ? a.ct[idx] : 0.0f;
      ai[i][R + c] = ok ? a.v[idx] : 0.0f;
    }
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        xi[i][k] = (row < n && k < d) ? xs * a.x[(size_t)row * d + k] : 0.0f;
    }
  }

  // the warp's [v_j | ct_j] and x_j of tile j, zero past the edges
  float* wb = s_wb + warp * 2 * wstride;
  float pb[PB], px[PX];
  auto fetch = [&](int j) {
    const int row0 = j * TILE + wcol;
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int e = lane + 32 * q;
      const int col = e / P, c = e % P;
      const int row = row0 + col;
      const int cc = c0 + (c < R ? c : c - R);
      const float* src = c < R ? a.v : a.ct;
      pb[q] = (e < BS_WCOLS * P && row < n && cc < r) ? src[(size_t)row * r + cc] : 0.0f;
    }
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int e = lane + 32 * q;
        const int col = e / D, k = e % D;
        const int row = row0 + col;
        px[q] = (e < BS_WCOLS * D && row < n && k < d) ? xs * a.x[(size_t)row * d + k] : 0.0f;
      }
    }
  };
  auto stash = [&](int j, float* buf) {
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int e = lane + 32 * q;
      if (e < BS_WCOLS * P) buf[(e / P) * LDB + e % P] = pb[q];
    }
    float* bx = buf + BS_WCOLS * LDB;
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const int e = lane + 32 * q;
        if (e < BS_WCOLS * D) bx[e] = px[q];
      }
    } else if constexpr (D == 0) {
      const int row0 = j * TILE + wcol;
      for (int e = lane; e < BS_WCOLS * d; e += 32) {
        const int row = row0 + e / d;
        bx[e] = row < n ? xs * a.x[(size_t)row * d + e % d] : 0.0f;
      }
    }
  };
  fetch(j0);
  stash(j0, wb);
  __syncthreads();  // the program, x_i (D = 0) and the first buffers are in place
  if constexpr (LEAF == 0) {
    if (threadIdx.x == 0) program_kids(s_prog, a.n_instr, s_kid);
    __syncthreads();
  }

  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;

  for (int j = j0; j < j1; ++j) {
    const float* cur = wb + ((j - j0) & 1) * wstride;
    if (j + 1 < j1) fetch(j + 1);

    float t[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) t[s] = 0.0f;
    if constexpr (D == X_SLICED) {
      float sq[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sq[i][jj] = 0.0f;
      // slice c of tile j is step (j - j0) nsl + c; the first is issued
      // with the first tile
      const int nsl = a.dp / X_SLICE, steps = (j1 - j0) * nsl;
      auto issue = [&](int u) {
        const int jt = j0 + u / nsl, cs = u % nsl;
        slice_rows<TILE, TILE>(s_xi + (u & 1) * 2 * TILE * X_SLICE_LD, a.xs, row_i, a.xs,
                               jt * TILE, a.dp, cs * X_SLICE);
        cp_async_commit();
      };
      if (j == j0) issue(0);
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
      // the entries weighed in D = 0's order
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float w[4];
        bs_pair_weights<P>(w, ai, cur + (4 * tx + jj) * LDB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bs_entry<LEAF>(sq[i][jj], w[i], t, s_prog, s_kid, s_coef, a.n_instr, a.need_l2);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 4 * tx + jj;
        float w[4];
        bs_pair_weights<P>(w, ai, cur + col * LDB);
        const float* xb = cur + BS_WCOLS * LDB + col * dx;
        float xj[D > 0 ? D : 1];
        if constexpr (D > 0) {
#pragma unroll
          for (int k = 0; k < D; ++k) xj[k] = xb[k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sq = 0.0f;
          if constexpr (D > 0) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const float u = xi[i][k] - xj[k];
              sq = fmaf(u, u, sq);
            }
          } else {
            const float* xa = s_xi + (ty + 16 * i) * d;
            for (int k = 0; k < d; ++k) {
              const float u = xa[k] - xb[k];
              sq = fmaf(u, u, sq);
            }
          }
          bs_entry<LEAF>(sq, w[i], t, s_prog, s_kid, s_coef, a.n_instr, a.need_l2);
        }
      }
    }
    // a diagonal tile holds each off-diagonal pair twice: half its weight
    const float half = j == ti ? 0.5f : 1.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] += (double)(t[s] * half);

    if (j + 1 < j1) stash(j + 1, wb + ((j + 1 - j0) & 1) * wstride);
    __syncwarp();
  }

  // the block's sums: a warp's lanes by a fixed butterfly, then the warps
  // in order; one float64 partial per item, pass and sum
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
    for (int w = 1; w < BS_WARPS; ++w) u += s_red[w * NS + threadIdx.x];
    a.part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NS + threadIdx.x] = u;
  }
}

// One instantiation's launch: grid (items, passes of R columns).
template <int R, int D, int LEAF>
cudaError_t bs_launch_one(const BwdSymArgs& a, int n_items, cudaStream_t st) {
  const size_t smem = sizeof(float) * bs_smem_floats<R, D>(a.d);
  cudaError_t err = prepare(matvec_bwd_sym_kernel<R, D, LEAF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_items, (unsigned)((a.r + R - 1) / R));
  matvec_bwd_sym_kernel<R, D, LEAF><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The pass widths: keep in sync with kernel_ops.BWD_SYM_WIDTHS.
template <int LEAF, int D>
cudaError_t bs_launch_d(const BwdSymArgs& a, int R, int n_items, cudaStream_t st) {
  switch (R) {
    case 1: return bs_launch_one<1, D, LEAF>(a, n_items, st);
    case 2: return bs_launch_one<2, D, LEAF>(a, n_items, st);
    case 4: return bs_launch_one<4, D, LEAF>(a, n_items, st);
    case 6: return bs_launch_one<6, D, LEAF>(a, n_items, st);
    case 9: return bs_launch_one<9, D, LEAF>(a, n_items, st);
    case 12: return bs_launch_one<12, D, LEAF>(a, n_items, st);
    case 16: return bs_launch_one<16, D, LEAF>(a, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}

// A compiled leaf at x width D (4 or 8; the sliced layout is
// gm_bwd_sym_launch_sliced).
template <int LEAF>
cudaError_t bs_launch_leaf(const BwdSymArgs& a, int R, int D, int n_items, cudaStream_t st) {
  switch (D) {
    case 4: return bs_launch_d<LEAF, 4>(a, R, n_items, st);
    case 8: return bs_launch_d<LEAF, 8>(a, R, n_items, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The Matern instantiations (gram_matvec_bwd_sym_matern.cu).
cudaError_t gm_bwd_sym_launch_matern(const BwdSymArgs& a, int leaf, int R, int D, int n_items,
                                     cudaStream_t st);
// Every route's sliced instantiations (gram_matvec_bwd_sym_sliced.cu).
cudaError_t gm_bwd_sym_launch_sliced(const BwdSymArgs& a, int leaf, int R, int n_items,
                                     cudaStream_t st);
