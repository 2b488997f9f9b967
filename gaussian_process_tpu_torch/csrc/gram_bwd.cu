// The dense kernel matrix's backward for NVIDIA Hopper (sm_90a): K5.
//
// For L = <ct, K(x1, x2)>, with K the tile gram's function (gram.cu: the
// postfix program on direct differences of inputs centred on mean(x1),
// White's variance coef[white_idx] on the diagonal of a same-set call), it
// returns dL/dcoef, the gradient in the program's coefficient vector, and,
// each only where asked, dL/dx1 and dL/dx2, without forming K. The
// coefficients are differentiable functions of the hyperparameters on the
// torch side, so autograd carries dL/dcoef on to every params tensor.
//
// Replaces the backward of the JAX package's gram_ad
// (ops/pallas/kernel_ops.py: _make_gram_ad, whose bwd is jax.vjp of the XLA
// gram); its forward is the tile gram, K1.
//
// What it computes, per entry (i, j) of the n x m grid:
//   dcoef[k] += ct_ij dk(sq_ij)/dcoef_k
//   dx1[i]   += ct_ij dk/dsq 2 (a_i - b_j),   dx2[j] -= the same
// and White's coefficient gets the trace of ct (a same-set call). A
// coincident pair adds nothing to dx (leaf_grad's rule): the x-gradient of
// a same-set Matern or Periodic gram is finite, where the JAX package's is
// NaN on the diagonal.
//
// What bounds it on this card: the read of ct. It is n m fp32 entries, read
// once; x1 and x2 are n d and m d floats. At 3.35 TB/s the floor is
// n m 4 bytes / 3.35e12, 80 us at 8192^2. The arithmetic is the entry (3d
// FMAs and one ex2 for the compiled RBF) and two or three FMAs of sums: at
// d = 4 about 19 operations an entry, a fifth of the read's time on the fp32
// pipe.
//
// What the design does about it:
//   * Tiles of 32 rows x 128 columns; each warp owns four rows of a tile,
//     each lane 16 bytes (4 adjacent columns) of each, so a warp moves 512
//     contiguous bytes a row. As many blocks as the card holds at once: the
//     column tiles in blockIdx.y, and each column's row tiles shared out in
//     blockIdx.x, walked by the block in a fixed order. Each tile's ct
//     arrives by cp.async (16 bytes, streaming past L1) in a ring of
//     GB_STAGES tiles in shared memory (4 x 16 KB), GB_STAGES - 1 tiles ahead
//     of the arithmetic: the bytes in flight cost no registers, and three
//     blocks (24 warps) fit an SM to hide the arithmetic's latencies. A
//     thread reads only the slots it copied, so the ring needs no barrier.
//     Rows past n and columns past m are zero-filled; a width that is not a
//     multiple of 4 (or a ct that is not 16-byte aligned) copies 4 bytes at
//     a time.
//   * Compiled leaves: a tree of one RBF or Matern leaf is an instantiation
//     (LEAF = its opcode) on x prescaled by leaf_x_scale, summing only
//     S0 = sum ct f and S1 = sum ct h (leaf_bwd_terms, K4's symmetric
//     sweep's terms), which the wrapper rescales into dL/dcoef
//     (kernel_ops.bwd_sym_coef). x sits in registers at a padded width D = 4
//     or 8, above d = 8 it is read in a loop (D = 0). Every other tree takes
//     LEAF = 0, tree_grad's interpreter, with d read in a loop; trees past
//     the sweeps' 16 instructions or coefficients take an instantiation
//     sized to the forward's limits (MAX_INSTR, MAX_COEF), its arrays in
//     local memory.
//   * The x-gradient only where asked (DX): each entry's weight
//     q = ct dk/dsq (compiled: ct phi, leaf_bwd_terms) is kept, then per
//     dimension the tile's row sums (a warp's butterfly) and column sums
//     (the warps in order, through shared memory) are written as fp32
//     partials per column tile and per row tile, which the wrapper sums in
//     a fixed order and scales (kernel_ops.gram_bwd_dx_scale). A call that
//     wants no dx (a training step's) runs an instantiation without any of
//     it.
//   * Equal bits on every run: a thread sums a tile's 16 entries in fp32
//     and the tiles in float64, the block reduces its threads in float64 in
//     a fixed order (a warp's lanes by a butterfly, then the warps in order)
//     and writes one float64 partial per block and sum; no atomics. The
//     grid depends only on the card, so a rerun on it walks the same tiles
//     in the same order. The wrapper sums the partials in a fixed order.

#include <algorithm>

#include "gram_matvec_common.cuh"

// What one launch reads and writes (device pointers).
struct GramBwdArgs {
  const float* x1;
  const float* x2;   // x1 for a same-set call
  const float* ct;
  double* part;      // blocks x (sums + 1): the route's sums, then the trace
  float* pdx1;       // column tiles x n x d: row sums of q (a - b); null: not wanted
  float* pdx2;       // row tiles x m x d: column sums of q (a - b); null: not wanted
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int white_idx;     // same-set White's coefficient (its sum is the trace), or -1
  int n, m, d, need_l2;
  int vec;           // ct rows may be read 16 bytes at a time
};

namespace {

constexpr int GB_WARPS = THREADS / 32;
constexpr int GB_COLS = 128;                 // tile columns: a warp's 32 lanes x 4
constexpr int GB_RPW = 4;                    // tile rows per warp
constexpr int GB_ROWS = GB_WARPS * GB_RPW;   // 32
constexpr int GB_STAGES = 4;                 // ct tiles in a block's ring
constexpr int GB_TILE = GB_ROWS * GB_COLS;   // floats of a ct tile

// The float64 sums a block writes before its trace: S0 and S1 for a compiled
// leaf, one per coefficient (at most NC) for the interpreter.
template <int LEAF, int NC>
__host__ __device__ constexpr int gb_sums() {
  return LEAF == 0 ? NC : 2;
}

// Shared memory of one block, in bytes: the ring of ct tiles, the block's
// reduction (doubles), the program and its operand table (the
// interpreter), the warps' column sums (DX).
__host__ __device__ constexpr size_t gb_smem_bytes(int ns, int ni, int nc, bool dx) {
  return sizeof(float) * GB_STAGES * GB_TILE + sizeof(double) * GB_WARPS * (ns + 1) +
         sizeof(float) * nc + sizeof(int) * 4 * ni +
         (dx ? sizeof(float) * GB_WARPS * GB_COLS : 0);
}

// cp.async of `bytes` (16 or 4) from global src to shared dst, the rest of
// the destination zero-filled from src_bytes on (0: all zero, src unread).
__device__ __forceinline__ void gb_cp16(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void gb_cp4(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void gb_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void gb_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row tile rt of ct, the thread's 16 bytes of each of its rows, into its own
// slots of a ring stage (zero past the edges): each thread later reads only
// what it copied, so the ring needs no barrier.
__device__ __forceinline__ void gb_copy_tile(float* stage, const GramBwdArgs& a, int rt,
                                             int warp, int lane, int c) {
#pragma unroll
  for (int i = 0; i < GB_RPW; ++i) {
    const int row = rt * GB_ROWS + warp + GB_WARPS * i;
    float* dst = stage + (warp + GB_WARPS * i) * GB_COLS + 4 * lane;
    const float* src = a.ct + (size_t)row * a.m + c;
    if (a.vec) {
      const bool ok = row < a.n && c < a.m;
      gb_cp16(dst, ok ? src : a.ct, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = row < a.n && c + jj < a.m;
        gb_cp4(dst + jj, ok ? src + jj : a.ct, ok ? 4 : 0);
      }
    }
  }
}

// Coordinate k of row `row` of x (rows x d), scaled; zero past the edges.
__device__ __forceinline__ float gb_x(const float* x, int row, int k, int rows, int d,
                                      float xs) {
  return (row < rows && k < d) ? xs * x[(size_t)row * d + k] : 0.0f;
}

__device__ __forceinline__ float gb_pick(const float (&v)[4], unsigned k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T u) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
  return u;
}

// One tile (row tile rt, the block's column tile) from its ct in registers:
// the route's sums into ts, the trace into tr, and (DX) the x-gradient's
// partials of the tile.
template <int LEAF, int D, bool DX, int NI, int NC>
__device__ __forceinline__ void gb_tile(const GramBwdArgs& a, const float4 (&ctv)[GB_RPW], int rt,
                                        int lane, int warp, int c, float xs,
                                        const float (&xj)[4][D > 0 ? D : 1],
                                        float (&ts)[gb_sums<LEAF, NC>()], float& tr,
                                        const int* s_prog, const int* s_kid, const float* s_coef,
                                        float* s_col) {
  constexpr int DR = D > 0 ? D : 1;
  const int n = a.n, m = a.m, d = a.d;
  const int row0 = rt * GB_ROWS + warp;  // the thread's rows: row0 + GB_WARPS i
  float q[DX ? GB_RPW : 1][4];           // each entry's x-gradient weight
#pragma unroll
  for (int i = 0; i < GB_RPW; ++i) {
    const int row = row0 + GB_WARPS * i;
    const float g[4] = {ctv[i].x, ctv[i].y, ctv[i].z, ctv[i].w};
    if (a.white_idx >= 0) {
      const unsigned k = (unsigned)(row - c);
      if (k < 4u) tr += gb_pick(g, k);
    }
    float xr[DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[k] = gb_x(a.x1, row, k, n, d, xs);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float sq = 0.0f;
      if constexpr (D > 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float u = xr[k] - xj[jj][k];
          sq = fmaf(u, u, sq);
        }
      } else {
        for (int k = 0; k < d; ++k) {
          const float u = gb_x(a.x1, row, k, n, d, xs) - gb_x(a.x2, c + jj, k, m, d, xs);
          sq = fmaf(u, u, sq);
        }
      }
      float qe = 0.0f;
      if constexpr (LEAF == 0) {
        qe = tree_grad<NI>(s_prog, s_kid, s_coef, a.n_instr, sq, a.need_l2 ? sqrtf(sq) : 0.0f,
                           g[jj], ts);
      } else {
        leaf_bwd_terms<LEAF, DX>(sq, g[jj], ts[0], ts[1], qe);
      }
      if constexpr (DX) q[i][jj] = qe;
    }
  }

  if constexpr (DX) {
    // per dimension: the tile's row sums and column sums of q (a - b)
    const int dd = D > 0 ? D : d;
#pragma unroll
    for (int k = 0; k < dd; ++k) {
      if (k >= d) break;  // uniform
      float xb[4], rs[GB_RPW], cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) xb[jj] = gb_x(a.x2, c + jj, k, m, d, xs);
#pragma unroll
      for (int i = 0; i < GB_RPW; ++i) {
        const float xa = gb_x(a.x1, row0 + GB_WARPS * i, k, n, d, xs);
        rs[i] = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = q[i][jj] * (xa - xb[jj]);
          rs[i] += p;
          cs[jj] += p;
        }
      }
      if (a.pdx1 != nullptr) {  // uniform
        float mine = 0.0f;  // lane i < GB_RPW writes row i's sum
#pragma unroll
        for (int i = 0; i < GB_RPW; ++i) {
          const float u = warp_sum(rs[i]);
          if (lane == i) mine = u;
        }
        const int row = row0 + GB_WARPS * lane;
        if (lane < GB_RPW && row < n) a.pdx1[((size_t)blockIdx.y * n + row) * d + k] = mine;
      }
      if (a.pdx2 != nullptr) {  // uniform
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s_col[warp * GB_COLS + 4 * lane + jj] = cs[jj];
        __syncthreads();
        if (threadIdx.x < GB_COLS) {
          float u = s_col[threadIdx.x];
#pragma unroll
          for (int w = 1; w < GB_WARPS; ++w) u += s_col[w * GB_COLS + threadIdx.x];
          const int col = blockIdx.y * GB_COLS + threadIdx.x;
          if (col < m) a.pdx2[((size_t)rt * m + col) * d + k] = u;
        }
        __syncthreads();
      }
    }
  }
}

// Block (s, ct) walks the row tiles s, s + gridDim.x, ... of column tile ct
// (blockIdx.y), their ct copied GB_STAGES - 1 tiles ahead into a ring.
template <int LEAF, int D, bool DX, int NI, int NC>
__global__ void __launch_bounds__(THREADS) gram_bwd_kernel(GramBwdArgs a) {
  constexpr int NS = gb_sums<LEAF, NC>();
  constexpr int DR = D > 0 ? D : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);                  // GB_STAGES x GB_TILE
  double* s_red = reinterpret_cast<double*>(ring + GB_STAGES * GB_TILE);  // warps x (NS + 1)
  float* s_coef = reinterpret_cast<float*>(s_red + GB_WARPS * (NS + 1));  // NC
  int* s_prog = reinterpret_cast<int*>(s_coef + NC);                  // 2 NI
  int* s_kid = s_prog + 2 * NI;                                       // 2 NI
  float* s_col = reinterpret_cast<float*>(s_kid + 2 * NI);            // warps x GB_COLS (DX)

  const int row_tiles = (a.n + GB_ROWS - 1) / GB_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * GB_COLS + 4 * lane;  // the thread's first column

  // the first tiles' ct before anything else: their copies are in flight
  // while the program and x arrive (one commit group a tile, empty past
  // the walk's end, so that the groups count tiles)
#pragma unroll
  for (int step = 0; step < GB_STAGES - 1; ++step) {
    const int rt = blockIdx.x + step * gridDim.x;
    if (rt < row_tiles) gb_copy_tile(ring + step * GB_TILE, a, rt, warp, lane, c);
    gb_commit();
  }

  if constexpr (LEAF == 0) {
    load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
    __syncthreads();
    if (threadIdx.x == 0) program_kids(s_prog, a.n_instr, s_kid);
    __syncthreads();
  }
  float amp, xs;  // the wrapper applies the amplitude
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);
  float xj[4][DR];
  if constexpr (D > 0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int k = 0; k < D; ++k) xj[jj][k] = gb_x(a.x2, c + jj, k, a.m, a.d, xs);
  }

  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;
  float tr = 0.0f;  // the trace's share (white_idx >= 0)
  int step = 0;  // the walk's tile `step` sits in ring stage step % GB_STAGES
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x, ++step) {
    const int ahead = rt + (GB_STAGES - 1) * gridDim.x;
    if (ahead < row_tiles)
      gb_copy_tile(ring + ((step + GB_STAGES - 1) % GB_STAGES) * GB_TILE, a, ahead, warp, lane,
                   c);
    gb_commit();
    gb_wait<GB_STAGES - 1>();  // this step's tile has landed
    const float* stage = ring + (step % GB_STAGES) * GB_TILE + warp * GB_COLS + 4 * lane;
    float4 cur[GB_RPW];
#pragma unroll
    for (int i = 0; i < GB_RPW; ++i)
      cur[i] = *reinterpret_cast<const float4*>(stage + GB_WARPS * i * GB_COLS);
    float ts[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) ts[s] = 0.0f;
    gb_tile<LEAF, D, DX, NI, NC>(a, cur, rt, lane, warp, c, xs, xj, ts, tr, s_prog, s_kid,
                                 s_coef, s_col);
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] += (double)ts[s];
  }
  gb_wait<0>();

  // the block's sums: a warp's lanes by a butterfly, then the warps in
  // order; one float64 partial per block and sum, the trace last
  const int ns = LEAF == 0 ? a.n_coef : NS;  // sums written before the trace
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= ns) break;  // uniform
    const double u = warp_sum(acc[s]);
    if (lane == 0) s_red[warp * (NS + 1) + s] = u;
  }
  {
    const double u = warp_sum((double)tr);
    if (lane == 0) s_red[warp * (NS + 1) + NS] = u;
  }
  __syncthreads();
  double* part = a.part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (ns + 1);
  for (int s = threadIdx.x; s <= ns; s += THREADS) {
    const int idx = s < ns ? s : NS;
    double u = s_red[idx];
#pragma unroll
    for (int w = 1; w < GB_WARPS; ++w) u += s_red[w * (NS + 1) + idx];
    part[s] = u;
  }
}

// One instantiation's launch: as many blocks as the card holds at once
// (at least one column strip each), the column tiles in blockIdx.y and each
// tile's row tiles shared out in blockIdx.x; *blocks receives their count,
// the rows of part written.
template <int LEAF, int D, bool DX, int NI, int NC>
cudaError_t gb_launch_one(const GramBwdArgs& a, long long* blocks, cudaStream_t st) {
  auto kernel = gram_bwd_kernel<LEAF, D, DX, NI, NC>;
  const size_t smem = gb_smem_bytes(gb_sums<LEAF, NC>(), NI, NC, DX);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (a.n + GB_ROWS - 1) / GB_ROWS;
  const int col_tiles = (a.m + GB_COLS - 1) / GB_COLS;
  // no more blocks than fit at once: a second, partial wave of whole
  // strips would double the time
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int strips = (int)std::min<long long>(row_tiles,
                                              std::max<long long>(1, resident / col_tiles));
  *blocks = (long long)strips * col_tiles;
  gram_bwd_kernel<LEAF, D, DX, NI, NC><<<dim3(strips, col_tiles), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// A compiled leaf at x width D (4, 8, or 0 for a loop over d).
template <int LEAF, bool DX>
cudaError_t gb_launch_leaf(const GramBwdArgs& a, long long* blocks, cudaStream_t st) {
  const int D = a.d <= 4 ? 4 : a.d <= 8 ? 8 : 0;
  switch (D) {
    case 4: return gb_launch_one<LEAF, 4, DX, MAX_BWD_INSTR, MAX_BWD_COEF>(a, blocks, st);
    case 8: return gb_launch_one<LEAF, 8, DX, MAX_BWD_INSTR, MAX_BWD_COEF>(a, blocks, st);
    default: return gb_launch_one<LEAF, 0, DX, MAX_BWD_INSTR, MAX_BWD_COEF>(a, blocks, st);
  }
}

template <bool DX>
cudaError_t gb_launch(const GramBwdArgs& a, int route, long long* blocks, cudaStream_t st) {
  switch (route) {
    case OP_RBF: return gb_launch_leaf<OP_RBF, DX>(a, blocks, st);
    case OP_MATERN12: return gb_launch_leaf<OP_MATERN12, DX>(a, blocks, st);
    case OP_MATERN32: return gb_launch_leaf<OP_MATERN32, DX>(a, blocks, st);
    case OP_MATERN52: return gb_launch_leaf<OP_MATERN52, DX>(a, blocks, st);
    case 0:
      if (a.n_instr <= MAX_BWD_INSTR && a.n_coef <= MAX_BWD_COEF)
        return gb_launch_one<0, 0, DX, MAX_BWD_INSTR, MAX_BWD_COEF>(a, blocks, st);
      return gb_launch_one<0, 0, DX, MAX_INSTR, MAX_COEF>(a, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// For L = <ct, K(x1, x2)>: part (float64; a row per block, at most one per
// tile, and a row of the route's sums and the trace) receives in its first
// *blocks rows one partial per block of the route's sums (route 0, the interpreter:
// dL/dcoef; a compiled leaf's opcode: S0, S1) and of the trace of ct
// (white_idx >= 0; a same-set call). pdx1 ((m + 127) / 128 x n x d) and
// pdx2 ((n + 31) / 32 x m x d), each only if not null, receive fp32 partials
// of the x-gradients' sums (kernel_ops.gram_bwd_cuda finishes them). x1
// (n x d), x2 (m x d, x1 for a same-set call), ct (n x m): contiguous fp32
// on the device; vec != 0 lets ct's rows be read 16 bytes at a time
// (m % 4 == 0 and ct 16-byte aligned). Returns cudaGetLastError() after the
// launch.
int gm_gram_bwd(const float* x1, const float* x2, const float* ct, double* part, float* pdx1,
                float* pdx2, const int* prog, int n_instr, const float* coef, int n_coef,
                int white_idx, int route, int n, int m, int d, int need_l2, int vec,
                long long* blocks, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || white_idx >= n_coef)
    return (int)cudaErrorInvalidValue;
  if (route != 0 && (n_instr != 1 || n_coef < 2)) return (int)cudaErrorInvalidValue;
  if ((m + GB_COLS - 1) / GB_COLS > 65535) return (int)cudaErrorInvalidValue;
  const GramBwdArgs a{x1, x2, ct, part, pdx1, pdx2, prog, n_instr, coef, n_coef, white_idx,
                      n, m, d, need_l2, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (pdx1 != nullptr || pdx2 != nullptr)
                              ? gb_launch<true>(a, route, blocks, st)
                              : gb_launch<false>(a, route, blocks, st);
  return (int)err;
}

}  // extern "C"
