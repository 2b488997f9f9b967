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
// 102400 x 2048. A single-leaf kernel spends one transcendental per entry
// (expf; sinf for the periodic families), which the SFUs (16 per clock per
// SM, about 3.6e12 per second on 132 SMs) finish in a quarter of the store
// floor; a four-leaf tree such as co2 comes close to it.
//
// What the design does about it:
//   * one block per 64 x 128 output tile (256 threads); the tile's 64 rows
//     of x1 and 128 rows of x2 (transposed) sit in shared memory with the
//     postfix program and its coefficients; for d <= 8 (a template
//     parameter) each thread keeps its column's coordinates in registers;
//   * thread t owns column t % 128 and rows t / 128 + 2 i, so a warp writes
//     32 neighbouring floats of one row: every store is one 128-byte line;
//   * the squared distance is sum_k (a_k - b_k)^2 by fp32 FMAs on centred
//     coordinates, and the leaves are gram_matvec_common.cuh's, in the same
//     order as the matvec sweeps' tile evaluator: the dense path and the
//     matrix-free path evaluate the same K to rounding;
//   * ragged edges are masked in the kernel: the output is written at its
//     own (n, m) shape, never padded and copied back.
// Simple SIMT code: streaming stores and a persistent grid are later work.

#include "gram_matvec_common.cuh"

namespace {

constexpr int GR_ROWS = 64;                       // x1 rows per block tile
constexpr int GR_COLS = 128;                      // x2 rows per block tile
constexpr int GR_ROW_STEP = THREADS / GR_COLS;    // rows a block pass covers

__host__ __device__ inline size_t gram_smem_bytes(int d) {
  return sizeof(float) * (size_t)(MAX_COEF + 2 * MAX_INSTR + (GR_ROWS + GR_COLS) * d);
}

// D > 0: d == D, known at compile time, and each thread keeps its column's
// coordinates in registers; D == 0: any d, read from shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS)
    gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                float* __restrict__ out, const int* __restrict__ prog, int n_instr,
                const float* __restrict__ coef, int n_coef, int white_idx, int n, int m,
                int d, int need_l2) {
  extern __shared__ float smem[];
  float* s_coef = smem;
  int* s_prog = reinterpret_cast<int*>(smem + MAX_COEF);
  float* xa = smem + MAX_COEF + 2 * MAX_INSTR;  // GR_ROWS x d, row-major
  float* xbt = xa + GR_ROWS * d;                 // d x GR_COLS, transposed
  const int row0 = blockIdx.x * GR_ROWS;
  const int col0 = blockIdx.y * GR_COLS;

  load_program(s_coef, s_prog, prog, n_instr, coef, n_coef);
  for (int idx = threadIdx.x; idx < GR_ROWS * d; idx += THREADS) {
    const int row = row0 + idx / d;
    xa[idx] = row < n ? x1[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < GR_COLS * d; idx += THREADS) {
    const int cc = idx / d, k = idx - cc * d;
    const int col = col0 + cc;
    xbt[k * GR_COLS + cc] = col < m ? x2[(size_t)col * d + k] : 0.0f;
  }
  __syncthreads();

  const int cc = threadIdx.x % GR_COLS;
  const int col = col0 + cc;
  if (col >= m) return;  // no barrier follows
  const float white = white_idx >= 0 ? s_coef[white_idx] : 0.0f;
  float b[D > 0 ? D : 1];
#pragma unroll
  for (int k = 0; k < D; ++k) b[k] = xbt[k * GR_COLS + cc];
  for (int rr = threadIdx.x / GR_COLS; rr < GR_ROWS; rr += GR_ROW_STEP) {
    const int row = row0 + rr;
    if (row >= n) break;
    const float* a = xa + rr * (D > 0 ? D : d);
    float sq = 0.0f;
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float t = a[k] - b[k];
        sq = fmaf(t, t, sq);
      }
    } else {
      for (int k = 0; k < d; ++k) {
        const float t = a[k] - xbt[k * GR_COLS + cc];
        sq = fmaf(t, t, sq);
      }
    }
    const float l2 = need_l2 ? sqrtf(sq) : 0.0f;
    float val = eval_tree(s_prog, s_coef, n_instr, sq, l2);
    if (white_idx >= 0 && row == col) val += white;
    out[(size_t)row * m + col] = val;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (the wrapper checks them against the
// card's limit before launching).
size_t gm_gram_smem_bytes(int d) { return gram_smem_bytes(d); }

// out (n x m) = K(x1, x2); x1 (n x d), x2 (m x d), all contiguous fp32 on
// the device (x2 may be x1). coef[white_idx] is added where row == col
// (white_idx < 0: nothing). Returns cudaGetLastError() after the launch.
int gm_gram(const float* x1, const float* x2, float* out, const int* prog, int n_instr,
            const float* coef, int n_coef, int white_idx, int n, int m, int d, int need_l2,
            void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || white_idx >= n_coef)
    return (int)cudaErrorInvalidValue;
  const long long col_tiles = ((long long)m + GR_COLS - 1) / GR_COLS;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + GR_ROWS - 1) / GR_ROWS), (unsigned)col_tiles);
  const size_t smem = gram_smem_bytes(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define GM_LAUNCH_GRAM(DV)                                                                \
  case DV:                                                                                \
    err = prepare(gram_kernel<DV>, smem);                                                 \
    if (err != cudaSuccess) return (int)err;                                              \
    gram_kernel<DV><<<grid, THREADS, smem, st>>>(x1, x2, out, prog, n_instr, coef, n_coef, \
                                                 white_idx, n, m, d, need_l2);            \
    break;
  switch (d <= 8 ? d : 0) {
    GM_LAUNCH_GRAM(0)
    GM_LAUNCH_GRAM(1)
    GM_LAUNCH_GRAM(2)
    GM_LAUNCH_GRAM(3)
    GM_LAUNCH_GRAM(4)
    GM_LAUNCH_GRAM(5)
    GM_LAUNCH_GRAM(6)
    GM_LAUNCH_GRAM(7)
    GM_LAUNCH_GRAM(8)
  }
#undef GM_LAUNCH_GRAM
  return (int)cudaGetLastError();
}

}  // extern "C"
