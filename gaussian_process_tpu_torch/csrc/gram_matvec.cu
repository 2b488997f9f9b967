// Fused kernel-matrix matvec out = K(x1, x2) @ V for NVIDIA Hopper (sm_90a),
// without ever materialising K: the full sweep K2, gm_matvec_full, which
// replaces _matvec_fwd_impl of the JAX package's ops/pallas/kernel_ops.py.
// The same-set sweep K3 (_matvec_fwd_sym_impl) is gram_matvec_sym.cu.
//
// What bounds it on this card. Per matvec at n = 102400 the full sweep
// evaluates n^2 ~ 1.05e10 kernel entries, each one transcendental (expf for
// RBF/Matern/RQ, plus sinf for the periodic families), and does 2 n^2 r
// fp32 FMAs for the output product (r = 16 -> 3.4e11 FLOPs). The SFU issue
// rate and the fp32 FMA pipe are the two ceilings; device memory is not:
// x and V are a few MB and stay in L2.
//
// What the design does about it:
//   * K is evaluated once per 64x64 tile into shared memory and consumed by
//     every column of V that the block owns (up to 128), so the
//     transcendental cost is amortised across right-hand sides. Blocks hold
//     all of V's columns when r <= 128, so a 65-column RHS evaluates K once.
//   * The sweep loops over all x2 tiles inside the block (this loop takes
//     the place of the TPU's sequential grid axis), so it needs no atomics:
//     each output row block is written once.
//   * The kernel tree is a small postfix program (opcodes + coefficient
//     offsets) in device memory that each block copies to shared memory and
//     interprets per entry. One build serves every tree and every
//     hyperparameter value; no hyperparameter is a compile-time constant.
//   * Squared distances are computed as sum_k (a_k - b_k)^2 with fp32 FMAs on
//     centred coordinates (no cancellation-prone norm expansion). The output
//     product is plain fp32 FMA, which is at least as precise as the TPU's
//     "highest" dot mode, so both dot modes run it.
// Simple SIMT fp32 code: wgmma, TMA pipelining and a tf32x3 output product
// are later work.

#include "gram_matvec_common.cuh"

namespace {

constexpr int TM = 4;             // output rows per thread (16 row groups x 4)
constexpr int MAX_TR = 8;         // up to 16 * 8 = 128 V columns per block

struct Smem {
  float* coef;
  int* prog;
  float* k;    // TILE x KS_LD kernel tile
  float* va;   // TILE x RT (V rows of the column tile)
  float* xa;   // TILE x d, row-major (rows of the tile)
  float* xbt;  // d x TILE, transposed (columns of the tile)
};

__host__ __device__ inline size_t smem_bytes(int rt, int d) {
  return sizeof(float) * (size_t)(MAX_COEF + 2 * MAX_INSTR + TILE * KS_LD + TILE * rt +
                                  2 * TILE * d);
}

__device__ __forceinline__ Smem carve(float* smem, int rt, int d) {
  Smem s;
  s.coef = smem;
  s.prog = reinterpret_cast<int*>(smem + MAX_COEF);
  s.k = smem + MAX_COEF + 2 * MAX_INSTR;
  s.va = s.k + TILE * KS_LD;
  s.xa = s.va + TILE * rt;
  s.xbt = s.xa + TILE * d;
  return s;
}

// rows [row0, row0 + TILE) and columns [c0, c0 + rt) of v (m x r) into dst
// (TILE x rt); entries past m or r are zero.
__device__ __forceinline__ void load_v(float* dst, const float* v, int row0, int m, int c0,
                                       int r, int rt) {
  for (int idx = threadIdx.x; idx < TILE * rt; idx += THREADS) {
    const int rr = idx / rt, cc = idx - rr * rt;
    const int row = row0 + rr, col = c0 + cc;
    dst[idx] = (row < m && col < r) ? v[(size_t)row * r + col] : 0.0f;
  }
}

// K tile: s.k[a][b] = k(xa[a], xb[b]).
__device__ __forceinline__ void eval_tile(const Smem& s, int d, int n_instr, int need_l2) {
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int a = e / TILE, b = e - a * TILE;
    const float* xa = s.xa + a * d;
    float sq = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float t = xa[k] - s.xbt[k * TILE + b];
      sq = fmaf(t, t, sq);
    }
    const float l2 = need_l2 ? sqrtf(sq) : 0.0f;
    s.k[a * KS_LD + b] = eval_tree(s.prog, s.coef, n_instr, sq, l2);
  }
}

// acc[i][j] += sum_k K[row_i][k] * v[k][col_j], row_i = ty + 16 i and
// col_j = tx + 16 j.
template <int TR>
__device__ __forceinline__ void tile_product(float (&acc)[TM][TR], const float* ks,
                                             const float* v, int tx, int ty) {
  constexpr int RT = 16 * TR;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float a[TM], b[TR];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = ks[(ty + 16 * i) * KS_LD + k];
#pragma unroll
    for (int j = 0; j < TR; ++j) b[j] = v[k * RT + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TR>
__global__ void __launch_bounds__(THREADS)
    matvec_full_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                       const float* __restrict__ v, float* __restrict__ out,
                       const int* __restrict__ prog, int n_instr,
                       const float* __restrict__ coef, int n_coef, int n, int m, int d, int r,
                       int need_l2) {
  constexpr int RT = 16 * TR;
  extern __shared__ float smem[];
  const Smem s = carve(smem, RT, d);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * TILE;
  const int c0 = blockIdx.y * RT;

  load_program(s.coef, s.prog, prog, n_instr, coef, n_coef);
  load_x(s.xa, x1, row0, n, d, false);

  float acc[TM][TR];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_x(s.xbt, x2, col0, m, d, true);
    load_v(s.va, v, col0, m, c0, r, RT);  // rows past m are zero: masks the ragged edge
    __syncthreads();
    eval_tile(s, d, n_instr, need_l2);
    __syncthreads();
    tile_product<TR>(acc, s.k, s.va, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < r) out[(size_t)row * r + col] = acc[i][j];
    }
  }
}

int column_tiles(int r) {  // 16-column groups a block holds, 1..MAX_TR
  int tr = (r + 15) / 16;
  return tr < 1 ? 1 : (tr > MAX_TR ? MAX_TR : tr);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (the wrapper checks them against the
// card's limit before launching).
size_t gm_smem_bytes(int r, int d) { return smem_bytes(16 * column_tiles(r), d); }

// out (n x r) = K(x1, x2) @ v; x1 (n x d), x2 (m x d), v (m x r), all
// contiguous fp32 on the device. Returns cudaGetLastError() after the launch.
int gm_matvec_full(const float* x1, const float* x2, const float* v, float* out,
                   const int* prog, int n_instr, const float* coef, int n_coef, int n, int m,
                   int d, int r, int need_l2, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  const int tr = column_tiles(r);
  const dim3 grid((n + TILE - 1) / TILE, (r + 16 * tr - 1) / (16 * tr));
  const size_t smem = smem_bytes(16 * tr, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define GM_LAUNCH_FULL(TRV)                                                               \
  case TRV:                                                                               \
    err = prepare(matvec_full_kernel<TRV>, smem);                                         \
    if (err != cudaSuccess) return (int)err;                                              \
    matvec_full_kernel<TRV><<<grid, THREADS, smem, st>>>(x1, x2, v, out, prog, n_instr,   \
                                                          coef, n_coef, n, m, d, r,       \
                                                          need_l2);                       \
    break;
  switch (tr) {
    GM_LAUNCH_FULL(1)
    GM_LAUNCH_FULL(2)
    GM_LAUNCH_FULL(3)
    GM_LAUNCH_FULL(4)
    GM_LAUNCH_FULL(5)
    GM_LAUNCH_FULL(6)
    GM_LAUNCH_FULL(7)
    GM_LAUNCH_FULL(8)
  }
#undef GM_LAUNCH_FULL
  return (int)cudaGetLastError();
}

}  // extern "C"
