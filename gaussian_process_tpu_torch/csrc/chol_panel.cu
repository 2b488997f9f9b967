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
// two block barriers each, and its sweep is a chain of launches.
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
//         diag   (one block): factor and invert the (s, s) tile in shared
//                memory, pivot by pivot (the recurrence of
//                _chol_inv_unblocked: L's column, W's row by forward
//                substitution, the rank-1 trailing update);
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

// Factor and invert the diagonal tile (s, s) of L in shared memory. Pivot j:
// L's column j is a[:, j] rsqrt(d) (d = a[j][j]); W's row j is
// (e_j - sum_{k<j} L[j, k] W[k, :]) rsqrt(d); then the trailing rank-1
// update of a and of the running sums. Rows <= j of w hold W, rows > j the
// running sums sum_k L[r, k] W[k, :].
__global__ void __launch_bounds__(THREADS) diag_kernel(float* L, float* W, int ld, int s) {
  __shared__ float a[S][LDS];
  __shared__ float w[S][LDS];
  __shared__ float lcol[S], wrow[S];
  float* Lt = tile(L, ld, s, s);
  float* Wt = tile(W, ld, s, s);
  for (int idx = threadIdx.x; idx < S * S; idx += THREADS) {
    const int r = idx / S, c = idx % S;
    a[r][c] = Lt[(size_t)r * ld + c];
    w[r][c] = 0.0f;
  }
  __syncthreads();
  const int c = threadIdx.x % S;  // this thread's column; rows r0, r0 + 4, ...
  const int r0 = threadIdx.x / S;
  for (int j = 0; j < S; ++j) {
    const float rs = rsqrtf(a[j][j]);
    if (threadIdx.x < S) {
      const int i = threadIdx.x;
      lcol[i] = i >= j ? a[i][j] * rs : 0.0f;
    } else if (threadIdx.x < 2 * S) {
      const int k = threadIdx.x - S;
      wrow[k] = k <= j ? ((k == j ? 1.0f : 0.0f) - w[j][k]) * rs : 0.0f;
    }
    __syncthreads();
    for (int r = r0; r < S; r += THREADS / S) {
      if (c == j) {
        if (r >= j) a[r][c] = lcol[r];
      } else if (c > j && r >= c) {
        a[r][c] = fmaf(-lcol[r], lcol[c], a[r][c]);
      }
      if (c <= j) {
        if (r == j)
          w[r][c] = wrow[c];
        else if (r > j)
          w[r][c] = fmaf(lcol[r], wrow[c], w[r][c]);
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < S * S; idx += THREADS) {
    const int r = idx / S, cc = idx % S;
    Lt[(size_t)r * ld + cc] = cc <= r ? a[r][cc] : 0.0f;
    Wt[(size_t)r * ld + cc] = cc <= r ? w[r][cc] : 0.0f;
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
