// Dense kernel matrix out = K(x1, x2) for NVIDIA Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel gram of the JAX package's
// ops/pallas/kernel_ops.py (with its helpers _build_common, _make_tile_eval
// and _tile_sqdist): K(x1, x2) tile by tile from inputs centred on mean(x1),
// the stationary kernel tree evaluated per entry, and, for a same-set call,
// White's variance added on the global diagonal.
//
// What bounds it on this card: the store. The output is n m fp32 entries,
// and nothing else of that size is read (x1 and x2 are n d and m d floats,
// d small). At 3.35 TB/s the floor is n m 4 bytes / 3.35e12: about 20 us
// at 4096^2, 80 us at 8192^2, 63 us at 102400 x 512 and 250 us at
// 102400 x 2048. A single-leaf kernel spends one transcendental per entry,
// which the SFUs (16 per clock per SM, about 3.6e12 per second on 132 SMs)
// finish in a quarter of the store floor; a four-leaf tree such as co2
// comes close to it.
//
// What the design does about it:
//   * Each block owns a 128 x 128 tile, each warp 16 of its rows, each lane
//     4 adjacent columns, so a lane writes 16 bytes a row and a warp 512
//     contiguous bytes; a width that is not a multiple of 4 (or an output
//     that is not 16-byte aligned) writes scalars, and the ragged edges are
//     masked: the output is written at its own (n, m) shape.
//   * A lane's 4 columns of x2 sit in registers for the whole tile and the
//     rows of x1 are read as the warp reaches them (one broadcast load a
//     coordinate), so the program and the x tiles are read once per 64 KB
//     of output (the old kernel: once per 32 KB).
//   * Compiled leaves: a tree of one RBF or Matern leaf is an instantiation
//     (LEAF = its opcode) on x prescaled by leaf_x_scale, one ex2.approx an
//     entry and the amplitude applied per entry, as the matrix-free sweeps
//     evaluate K (gram_matvec_common.cuh's leaf_entry); every other tree
//     is interpreted (eval_tree, LEAF = 0). x sits in registers at a padded
//     width D = 4 or 8, above d = 8 it is read in a loop (D = 0).
//   * The squared distance is sum_k (a_k - b_k)^2 by fp32 FMAs on centred
//     coordinates.
//   * Stores carry the streaming hint (st.global.cs, evict first): K is
//     written once, larger than L2 at the paths' shapes, and read later by
//     another kernel. Chosen by measurement on the card: the hint was
//     faster than the default policy at all three path shapes.

#include "gram_matvec_common.cuh"

// What one launch reads and writes (device pointers).
struct GramArgs {
  const float* x1;
  const float* x2;  // x1 for a same-set call
  float* out;
  const int* prog;
  int n_instr;
  const float* coef;
  int n_coef;
  int white_idx;    // coef[white_idx] goes on the diagonal, or -1
  int n, m, d, need_l2;
  int vec;          // out's rows may be written 16 bytes at a time
};

namespace {

constexpr int GR_WARPS = THREADS / 32;
constexpr int GR_COLS = 128;                 // tile columns: a warp's 32 lanes x 4
constexpr int GR_RPW = 16;                   // tile rows per warp
constexpr int GR_ROWS = GR_WARPS * GR_RPW;   // 128

__host__ __device__ constexpr size_t gram_smem_bytes() {
  return sizeof(float) * MAX_COEF + sizeof(int) * 2 * MAX_INSTR;
}

__device__ __forceinline__ float gr_x(const float* x, int row, int k, int rows, int d,
                                      float xs) {
  return (row < rows && k < d) ? xs * x[(size_t)row * d + k] : 0.0f;
}

template <int LEAF, int D>
__global__ void __launch_bounds__(THREADS) gram_kernel(GramArgs a) {
  constexpr int DR = D > 0 ? D : 1;
  extern __shared__ __align__(16) float smem[];
  float* s_coef = smem;                                        // MAX_COEF (LEAF = 0)
  int* s_prog = reinterpret_cast<int*>(smem + MAX_COEF);       // 2 MAX_INSTR (LEAF = 0)
  const int n = a.n, m = a.m, d = a.d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * GR_ROWS + warp * GR_RPW;      // the warp's rows
  const int c = blockIdx.y * GR_COLS + 4 * lane;              // the lane's first column

  if constexpr (LEAF == 0) {
    load_program(s_coef, s_prog, a.prog, a.n_instr, a.coef, a.n_coef);
    __syncthreads();
  }
  if (c >= m) return;  // no barrier follows
  float amp, xs;
  leaf_scales<LEAF>(a.prog, a.coef, amp, xs);
  const float white = a.white_idx >= 0 ? a.coef[a.white_idx] : 0.0f;
  float xj[4][DR];
  if constexpr (D > 0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int k = 0; k < D; ++k) xj[jj][k] = gr_x(a.x2, c + jj, k, m, d, xs);
  }
  const bool vec = a.vec && c + 3 < m;

#pragma unroll 4
  for (int rr = 0; rr < GR_RPW; ++rr) {
    const int row = row0 + rr;
    if (row >= n) break;
    float xr[DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[k] = gr_x(a.x1, row, k, n, d, xs);
    }
    float val[4];
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
          const float u = gr_x(a.x1, row, k, n, d, xs) - gr_x(a.x2, c + jj, k, m, d, xs);
          sq = fmaf(u, u, sq);
        }
      }
      if constexpr (LEAF == 0)
        val[jj] = leaf_entry<0>(sq, s_prog, s_coef, a.n_instr, a.need_l2);
      else
        val[jj] = amp * leaf_entry<LEAF>(sq, s_prog, s_coef, a.n_instr, a.need_l2);
    }
    if (a.white_idx >= 0) {
      const unsigned k = (unsigned)(row - c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (k == (unsigned)jj) val[jj] += white;
    }
    float* o = a.out + (size_t)row * m + c;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(val[0], val[1], val[2], val[3]));
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (c + jj < m) __stcs(o + jj, val[jj]);
    }
  }
}

template <int LEAF, int D>
cudaError_t gr_launch_one(const GramArgs& a, cudaStream_t st) {
  const size_t smem = LEAF == 0 ? gram_smem_bytes() : 0;
  const dim3 grid((unsigned)((a.n + GR_ROWS - 1) / GR_ROWS),
                  (unsigned)((a.m + GR_COLS - 1) / GR_COLS));
  gram_kernel<LEAF, D><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// x width D: 4, 8, or 0 for a loop over d.
template <int LEAF>
cudaError_t gr_launch_leaf(const GramArgs& a, cudaStream_t st) {
  if (a.d <= 4) return gr_launch_one<LEAF, 4>(a, st);
  if (a.d <= 8) return gr_launch_one<LEAF, 8>(a, st);
  return gr_launch_one<LEAF, 0>(a, st);
}

}  // namespace

extern "C" {

// out (n x m) = K(x1, x2); x1 (n x d), x2 (m x d), all contiguous fp32 on
// the device (x2 may be x1). coef[white_idx] is added where row == col
// (white_idx < 0: nothing). route: the leaf's opcode for a compiled tree of
// one RBF or Matern leaf (kernel_ops.sym_route), 0 for the interpreter.
// vec != 0: out's rows may be written 16 bytes at a time (m % 4 == 0 and
// out 16-byte aligned). Returns cudaGetLastError() after the launch.
int gm_gram(const float* x1, const float* x2, float* out, const int* prog, int n_instr,
            const float* coef, int n_coef, int white_idx, int route, int n, int m, int d,
            int need_l2, int vec, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || white_idx >= n_coef)
    return (int)cudaErrorInvalidValue;
  if (route != 0 && (n_instr != 1 || n_coef < 2)) return (int)cudaErrorInvalidValue;
  if ((m + GR_COLS - 1) / GR_COLS > 65535) return (int)cudaErrorInvalidValue;
  const GramArgs a{x1, x2, out, prog, n_instr, coef, n_coef, white_idx, n, m, d, need_l2, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0: return (int)gr_launch_leaf<0>(a, st);
    case OP_RBF: return (int)gr_launch_leaf<OP_RBF>(a, st);
    case OP_MATERN12: return (int)gr_launch_leaf<OP_MATERN12>(a, st);
    case OP_MATERN32: return (int)gr_launch_leaf<OP_MATERN32>(a, st);
    case OP_MATERN52: return (int)gr_launch_leaf<OP_MATERN52>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
