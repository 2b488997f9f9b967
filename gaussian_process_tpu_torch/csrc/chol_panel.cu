// Panel Cholesky factor and inverse for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel chol_inv_panel of the JAX package's
// ops/pallas/chol.py:155 (its body _panel_kernel :113 and the unblocked
// pivot recurrence _chol_inv_unblocked :65): for one SPD (b, b) fp32 panel,
// b <= 1024, the lower factor L with A = L L^T and W = L^{-1}, both lower
// triangular with exact zeros above the diagonal. Only A's lower triangle is
// read. A non-positive pivot d gives NaN or Inf through rsqrtf(d), so L's
// diagonal entry d * rsqrtf(d) is NaN and every later pivot inherits it: no
// clamp and no early exit, as the blocked factorization's NaN check needs.
//
// What bounds it on this card: operations. The factor takes b^3 / 3 flops
// and the inverse b^3 / 3 more, 7.2e8 at b = 1024: 10.7 us at the 67 TFLOP/s
// of fp32 outside the tensor cores. The bytes are A read once and L, W
// written once, 3 b^2 4 = 12.6 MB: 3.8 us at 3.35 TB/s. So about 0.011 ms.
// This simple design sits far above that: its b pivots are dependent steps,
// one block barrier each, and its sweep is a chain of launches. The pivots
// are latency: a pivot's arithmetic is a few FMAs a thread, so what counts
// is the chain from one pivot's shared-memory read through rsqrtf and the
// update to the next barrier.
//
// What the design does about it:
//   * the TPU kernel holds three (b, b) buffers in VMEM (12 MB at b = 1024);
//     a Hopper block has at most 227 KB of shared memory. So the panel lives
//     in device memory, where L and W (8 MB) stay resident in the 50 MB L2,
//     and only 64 x 64 tiles come into shared memory;
//   * blocks run in no order and carry nothing between them, so the TPU's
//     sequential sweep over sub-panels becomes a chain of launches on the
//     caller's stream, right-looking over S = 64 columns at a time:
//       init:   L = the lower block triangle of A, W = 0;
//       for each sub-panel s, with W_ss = L_ss^{-1}:
//         diag   (one block): factor and invert the (s, s) tile held in
//                registers, pivot by pivot (the recurrence of
//                _chol_inv_unblocked: L's column, W's row by forward
//                substitution, the rank-1 trailing update), with only the
//                next pivot's column and row published in shared memory;
//         panel  (a grid): L[t, s] = A[t, s] W_ss^T for each tile t > s, and
//                W[s, u] = W_ss B[s, u] for each u < s;
//         update (a grid): A[t, u] -= L[t, s] L[u, s]^T for t >= u > s (the
//                lower tiles only), and B[t, u] -= L[t, s] W[s, u] for t > s,
//                u <= s.
//     The B halves solve L X = I by block forward substitution in the same
//     sweep: B starts as I, lives in W's buffer and ends as W. It is the
//     recurrence of the TPU kernel's inverse assembly (:135-150), taken row
//     block by row block, so its tiles spread over the grid instead of one
//     column block per block;
//   * L is the working copy: the Schur complements are updated in place and
//     overwritten by the factor. The wrapper allocates L and W; the kernels
//     allocate nothing;
//   * every product is fp32 FMAs in the kernels' own code: each of 256
//     threads keeps a 4 x 4 register tile over the 64-deep inner dimension,
//     both operands staged in shared memory (no cuBLAS, no tensor cores);
//   * a b that is not a multiple of 64: the wrapper passes buffers of side
//     ld = 64 ceil(b / 64) and init extends A by the identity, as the JAX
//     wrapper pads to a multiple of 128.
// One call makes 3 ld / 64 launches (2 when ld = 64): init, one diag and one
// panel per sub-panel, and one update for each sub-panel but the last. At
// b = 1024 that is 48. wgmma, TMA and one persistent kernel are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 64;           // tile side (sub-panel width)
constexpr int LDS = S + 1;      // padded shared-memory row
constexpr int THREADS = 256;    // threads per block
constexpr int MAX_LD = 1024;    // the JAX kernel's _MAX_PANEL

__device__ __forceinline__ float* tile(float* x, int ld, int t, int u) {
  return x + (size_t)t * S * ld + (size_t)u * S;
}

// dst[k][r] = src[r][k]: a row-major tile, transposed into shared memory
// (consecutive threads read consecutive global addresses).
__device__ __forceinline__ void load_t(float (*dst)[LDS], const float* src, int ld) {
  for (int idx = threadIdx.x; idx < S * S; idx += THREADS) {
    const int r = idx / S, k = idx % S;
    dst[k][r] = src[(size_t)r * ld + k];
  }
}

// dst[k][c] = src[k][c]
__device__ __forceinline__ void load_n(float (*dst)[LDS], const float* src, int ld) {
  for (int idx = threadIdx.x; idx < S * S; idx += THREADS) {
    const int k = idx / S, c = idx % S;
    dst[k][c] = src[(size_t)k * ld + c];
  }
}

// out = P (subtract = false) or out -= P, P[r][c] = sum_k a[k][r] b[k][c]:
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
__device__ __forceinline__ void tile_product(float (*a)[LDS], float (*b)[LDS], float* out,
                                             int ld, bool subtract) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
#pragma unroll 4
  for (int k = 0; k < S; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = out + (size_t)(ty + 16 * i) * ld + tx + 16 * j;
      *o = subtract ? *o - acc[i][j] : acc[i][j];
    }
}

// L = the lower block triangle of A (ld x ld, A extended by the identity
// past b), zero above it; W = 0.
__global__ void __launch_bounds__(THREADS)
    init_kernel(const float* __restrict__ A, float* __restrict__ L, float* __restrict__ W,
                int b, int ld) {
  const size_t total = (size_t)ld * ld;
  for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * THREADS) {
    const int r = (int)(idx / ld), c = (int)(idx % ld);
    float v = 0.0f;
    if (r / S >= c / S) v = (r < b && c < b) ? A[(size_t)r * b + c] : (r == c ? 1.0f : 0.0f);
    L[idx] = v;
    W[idx] = 0.0f;
  }
}

constexpr int ROWS = S * S / THREADS;  // tile rows a thread of diag_kernel owns (16)

// Factor and invert the diagonal tile (s, s) of L. Pivot j: L's column j is
// a[:, j] rsqrt(d) (d = a[j][j]); W's row j is
// (e_j - sum_{k<j} L[j, k] W[k, :]) rsqrt(d); then the trailing rank-1
// update of a and of the running sums. Rows <= j of w hold W, rows > j the
// running sums sum_k L[r, k] W[k, :].
//
// The tile lives in registers: thread t owns column c = t % 64 and rows
// 16 g + k (g = t / 64, k = 0..15) of a and of w, 32 values whose indices
// are compile-time constants (the k loops are unrolled). A pivot needs from
// other threads only a's column j and w's row j, as they stand after pivot
// j - 1. Their owners publish them into two double-buffered shared vectors
// (col, row) right after their update, so one barrier a pivot orders
// everything: a buffer is rewritten two pivots after it was read, behind
// the barrier in between.
//
// A pivot's arithmetic is a few FMAs a thread, so its cost is issue and
// latency: eight warps share four schedulers, and every instruction of the
// update is paid once a pivot by each warp. So the update does no work it
// can avoid (on an H100, forms that masked every entry by its row, or that
// indexed the register array by the runtime pivot, took three to ten times
// the cycles a pivot):
//   * a lane with c > j updates all its rows of a: the rows below the
//     diagonal are the trailing update, those above it are never read
//     unmasked and are zeroed on output;
//   * a lane with c <= j updates w; only the two warps holding row j test
//     rows;
//   * the warps whose rows all lie above the pivot skip it (a branch uniform
//     over the warp);
//   * a's column c is left raw after its pivot and scaled on output by that
//     pivot's rsqrt, which the thread keeps: l = a[r][c] rs_c is the same
//     product either way;
//   * the pivot loop is unrolled by 16, one warp pair's rows at a time, so
//     which register holds row j + 1 of w, the buffer's parity and the row
//     tests of the warps holding row j are compile-time constants (a
//     runtime index into the register array compiles to a ladder of
//     compares and branches).
// Each entry is l = a[r][j] rs, a[r][c] = fmaf(-l, L[c][j], a[r][c]) and
// w[r][c] = fmaf(l, W[j][c], w[r][c]), with W[j][c] = ((c == j) -
// w[j][c]) rs, so an indefinite pivot makes NaN of exactly the entries it
// reaches in the recurrence.
__global__ void __launch_bounds__(THREADS) diag_kernel(float* L, float* W, int ld, int s) {
  __shared__ __align__(16) float col[2][S];
  __shared__ float row[2][S];
  float* Lt = tile(L, ld, s, s);
  float* Wt = tile(W, ld, s, s);
  const int c = threadIdx.x % S;
  const int r0 = (threadIdx.x / S) * ROWS;  // this thread's first row
  float a[ROWS], w[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    a[k] = Lt[(size_t)(r0 + k) * ld + c];
    w[k] = 0.0f;
  }
  if (c == 0) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) col[0][r0 + k] = a[k];
  }
  if (r0 == 0) row[0][c] = 0.0f;
  __syncthreads();
  float rs_own = 0.0f;  // rsqrt of this thread's column's pivot
#pragma unroll 1
  for (int jb = 0; jb < S; jb += ROWS) {  // the pivots of one warp pair's rows
#pragma unroll
    for (int jj = 0; jj < ROWS; ++jj) {  // unrolled: jj, the buffer and k's tests are constants
      const int j = jb + jj, p = jj & 1;
      const float rs = rsqrtf(col[p][j]);
      if (c == j) rs_own = rs;
      if (r0 >= jb) {  // some of this warp's rows are at or below the pivot
        float l[ROWS];  // L[r][j], used where r >= j
        const float4* mine = reinterpret_cast<const float4*>(&col[p][r0]);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 v = mine[q];
          l[4 * q] = v.x * rs;
          l[4 * q + 1] = v.y * rs;
          l[4 * q + 2] = v.z * rs;
          l[4 * q + 3] = v.w * rs;
        }
        if (c > j) {
          const float lc = col[p][c] * rs;  // L[c][j]
#pragma unroll
          for (int k = 0; k < ROWS; ++k) a[k] = fmaf(-l[k], lc, a[k]);
        } else {
          const float wr = ((c == j ? 1.0f : 0.0f) - row[p][c]) * rs;  // W[j][c]
          if (r0 > jb) {
#pragma unroll
            for (int k = 0; k < ROWS; ++k) w[k] = fmaf(l[k], wr, w[k]);
          } else {  // the warps holding row j: row r0 + k is row j at k = jj
#pragma unroll
            for (int k = jj; k < ROWS; ++k) w[k] = k == jj ? wr : fmaf(l[k], wr, w[k]);
          }
        }
      }
      if (j + 1 < S) {
        if (c == j + 1) {
          float4* dst = reinterpret_cast<float4*>(&col[p ^ 1][r0]);
#pragma unroll
          for (int q = 0; q < ROWS / 4; ++q)
            dst[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
        }
        // row j + 1 of w is row (jj + 1) % ROWS of the warps from jb or jb + ROWS
        if (r0 == jb + (jj + 1) / ROWS * ROWS) row[p ^ 1][c] = w[(jj + 1) % ROWS];
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = r0 + k;
    Lt[(size_t)r * ld + c] = c <= r ? a[k] * rs_own : 0.0f;
    Wt[(size_t)r * ld + c] = c <= r ? w[k] : 0.0f;
  }
}

// Blocks [0, below): L[t, s] = A[t, s] W_ss^T, t = s + 1 + block (in place);
// blocks [below, below + s): W[s, u] = W_ss B[s, u], u = block - below.
__global__ void __launch_bounds__(THREADS)
    panel_kernel(float* L, float* W, int ld, int s, int below) {
  __shared__ float a[S][LDS];
  __shared__ float b[S][LDS];
  const float* Wss = tile(W, ld, s, s);
  float* out;
  if ((int)blockIdx.x < below) {
    out = tile(L, ld, s + 1 + blockIdx.x, s);
    load_t(a, out, ld);
    load_t(b, Wss, ld);
  } else {
    out = tile(W, ld, s, blockIdx.x - below);
    load_t(a, Wss, ld);
    load_n(b, out, ld);
  }
  __syncthreads();
  tile_product(a, b, out, ld, false);
}

// Blocks [0, rest (rest + 1) / 2): A[t, u] -= L[t, s] L[u, s]^T over the
// lower tiles t >= u > s; the next rest (s + 1) blocks: B[t, u] -=
// L[t, s] W[s, u] for t > s, u <= s.
__global__ void __launch_bounds__(THREADS)
    update_kernel(float* L, float* W, int ld, int s, int rest) {
  __shared__ float a[S][LDS];
  __shared__ float b[S][LDS];
  int idx = blockIdx.x;
  const int n_lower = rest * (rest + 1) / 2;
  float* out;
  if (idx < n_lower) {
    int i = (int)((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
    while (i * (i + 1) / 2 > idx) --i;
    while ((i + 1) * (i + 2) / 2 <= idx) ++i;
    const int t = s + 1 + i, u = s + 1 + idx - i * (i + 1) / 2;
    out = tile(L, ld, t, u);
    load_t(a, tile(L, ld, t, s), ld);
    load_t(b, tile(L, ld, u, s), ld);
  } else {
    idx -= n_lower;
    const int t = s + 1 + idx / (s + 1), u = idx % (s + 1);
    out = tile(W, ld, t, u);
    load_t(a, tile(L, ld, t, s), ld);
    load_n(b, tile(W, ld, s, u), ld);
  }
  __syncthreads();
  tile_product(a, b, out, ld, true);
}

}  // namespace

extern "C" {

// L, W (ld x ld, ld = 64 ceil(b / 64) <= 1024) from the (b x b) panel A, all
// contiguous fp32 on the device: A's factor and inverse in their leading
// (b x b) blocks. Launches on `stream`; returns the first launch error, else
// cudaGetLastError().
int gm_chol_inv_panel(const float* A, float* L, float* W, int b, int ld, void* stream) {
  if (b < 1 || ld < b || ld % S != 0 || ld > MAX_LD || ld - b >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsub = ld / S;
  cudaError_t err;
  const int init_blocks = (int)(((size_t)ld * ld + THREADS - 1) / THREADS);
  init_kernel<<<init_blocks < 1024 ? init_blocks : 1024, THREADS, 0, st>>>(A, L, W, b, ld);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int s = 0; s < nsub; ++s) {
    diag_kernel<<<1, THREADS, 0, st>>>(L, W, ld, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int rest = nsub - 1 - s;
    if (nsub > 1) {
      panel_kernel<<<nsub - 1, THREADS, 0, st>>>(L, W, ld, s, rest);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (rest > 0) {
      update_kernel<<<rest * (rest + 1) / 2 + rest * (s + 1), THREADS, 0, st>>>(L, W, ld, s,
                                                                              rest);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
