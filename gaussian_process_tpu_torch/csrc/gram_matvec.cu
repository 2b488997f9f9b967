// Fused kernel-matrix matvec out = K(x1, x2) @ V for NVIDIA Hopper (sm_90a),
// without ever materialising K.
//
// Replaces the two forward Pallas TPU kernels of
// the JAX package's ops/pallas/kernel_ops.py:
//   gm_matvec_full  <- _matvec_fwd_impl      (full sweep, any x1/x2)
//   gm_matvec_sym   <- _matvec_fwd_sym_impl  (same-set, upper-triangle tiles)
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
//   * The symmetric sweep evaluates only the upper-triangle tiles (half the
//     transcendentals). GPU blocks run concurrently and in no order, so the
//     two contributions of a tile (T V_j into out_i and T^T V_i into out_j)
//     meet in one sum across blocks. fp32 atomicAdd would make that sum
//     depend on the order of the adds, and its bits change from run to run
//     (the TPU's sequential grid gives the same bits every time). So each
//     contribution is rounded to a 64-bit fixed-point integer and added with
//     an integer atomicAdd, which is associative: any order gives the same
//     bits. A second launch turns the integers into the fp32 output.
//   * Fixed point (matvec_sym_kernel, sym_finish_kernel). Column c has its
//     own scale 2^e_c, chosen by the wrapper (ops/cuda/kernel_ops.py,
//     sym_fixed_point_scales) so that k(0) sum_j |V[j, c]| 2^e_c <= 2^61.
//     Every tree the wrapper encodes is a white-free stationary
//     positive-definite kernel, and such a kernel has |k(r)| <= k(0) (tested
//     for every family in tests/test_torch_kernel_ops.py). So out[i, c] and
//     every partial sum of its contributions are at most
//     k(0) sum_j |V[j, c]| in magnitude, and the fp32 rounding of a tile's
//     64-term partial adds far less than the factor 4 left below 2^63: no
//     sum can overflow. The resolution is 2^-61 of that bound, far finer
//     than fp32 atomics, which round at |out| 2^-24 on every add. The scale
//     is applied in double, where 2^e_c and acc 2^e_c are exact for any e_c.
//   * Sign convention: a contribution is a two's-complement int64, added as
//     unsigned long long (atomicAdd has no signed 64-bit form). An
//     intermediate sum may wrap around; the wraparound cancels exactly, since
//     the final sum fits in int64 by the bound above.
//   * NaN and Inf: an integer cannot hold them (__double2ll_rn(NaN) is a
//     number). A non-finite partial sets its column's flag with atomicOr; the
//     wrapper sets the flag of a column whose bound is not finite (NaN or Inf
//     in V or in the params); the finishing pass writes NaN into a flagged
//     column, as an fp32 sum would carry the NaN into every row.
//   * The full sweep loops over all x2 tiles inside the block (this loop
//     takes the place of the TPU's sequential grid axis), so it needs no
//     atomics: each output row block is written once.
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
  float* vb;   // TILE x RT (V rows of the row tile; symmetric sweep only)
  float* xa;   // TILE x d, row-major (rows of the tile)
  float* xbt;  // d x TILE, transposed (columns of the tile)
};

__host__ __device__ inline size_t smem_bytes(int rt, int d, bool two_v) {
  return sizeof(float) * (size_t)(MAX_COEF + 2 * MAX_INSTR + TILE * KS_LD +
                                  (two_v ? 2 : 1) * TILE * rt + 2 * TILE * d);
}

__device__ __forceinline__ Smem carve(float* smem, int rt, int d, bool two_v) {
  Smem s;
  s.coef = smem;
  s.prog = reinterpret_cast<int*>(smem + MAX_COEF);
  s.k = smem + MAX_COEF + 2 * MAX_INSTR;
  s.va = s.k + TILE * KS_LD;
  s.vb = s.va + TILE * rt;
  s.xa = s.vb + (two_v ? TILE * rt : 0);
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

// acc[i][j] += sum_k K[row_i][k] * v[k][col_j]            (transpose = false)
// acc[i][j] += sum_k K[k][row_i] * v[k][col_j]            (transpose = true)
// with row_i = ty + 16 i and col_j = tx + 16 j.
template <int TR>
__device__ __forceinline__ void tile_product(float (&acc)[TM][TR], const float* ks,
                                             const float* v, int tx, int ty, bool transpose) {
  constexpr int RT = 16 * TR;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float a[TM], b[TR];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = transpose ? ks[k * KS_LD + ty + 16 * i] : ks[(ty + 16 * i) * KS_LD + k];
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
  const Smem s = carve(smem, RT, d, false);
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
    tile_product<TR>(acc, s.k, s.va, tx, ty, false);
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

// Adds the partial tile acc into the fixed-point sums: round(acc 2^e_col)
// with an integer atomicAdd; a non-finite partial flags its column.
template <int TR>
__device__ __forceinline__ void fixed_flush(const float (&acc)[TM][TR],
                                            unsigned long long* sum, unsigned int* flag,
                                            const double* scale, int row0, int n, int c0, int r,
                                            int tx, int ty) {
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const int col = c0 + tx + 16 * j;
    if (col >= r) continue;
    const double s = scale[col];
    bool finite = true;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= n) continue;
      finite &= isfinite(acc[i][j]);
      const long long q = __double2ll_rn((double)acc[i][j] * s);
      atomicAdd(sum + (size_t)row * r + col, (unsigned long long)q);
    }
    if (!finite) atomicOr(flag + col, 1u);
  }
}

// One block per upper-triangle tile (ti <= tj) of the p x p tile grid.
template <int TR>
__global__ void __launch_bounds__(THREADS)
    matvec_sym_kernel(const float* __restrict__ x, const float* __restrict__ v,
                      unsigned long long* __restrict__ sum, unsigned int* __restrict__ flag,
                      const double* __restrict__ scale, const int* __restrict__ prog,
                      int n_instr, const float* __restrict__ coef, int n_coef, int n, int d,
                      int r, int p, int need_l2) {
  constexpr int RT = 16 * TR;
  extern __shared__ float smem[];
  const Smem s = carve(smem, RT, d, true);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.y * RT;

  // linear index t -> (ti, tj): row ti of the triangle holds p - ti tiles
  // and starts at start(ti) = ti p - ti (ti - 1) / 2.
  const long long t = blockIdx.x;
  const double b2 = 2.0 * p + 1.0;
  long long ti = (long long)((b2 - sqrt(b2 * b2 - 8.0 * (double)t)) * 0.5);
  auto start = [p](long long i) { return i * p - i * (i - 1) / 2; };
  if (ti < 0) ti = 0;
  while (ti + 1 < p && start(ti + 1) <= t) ++ti;
  while (ti > 0 && start(ti) > t) --ti;
  const long long tj = ti + (t - start(ti));
  const int row_i = (int)ti * TILE, row_j = (int)tj * TILE;

  load_program(s.coef, s.prog, prog, n_instr, coef, n_coef);
  load_x(s.xa, x, row_i, n, d, false);
  load_x(s.xbt, x, row_j, n, d, true);
  load_v(s.va, v, row_j, n, c0, r, RT);
  load_v(s.vb, v, row_i, n, c0, r, RT);
  __syncthreads();
  eval_tile(s, d, n_instr, need_l2);
  __syncthreads();

  float acc[TM][TR];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
  tile_product<TR>(acc, s.k, s.va, tx, ty, false);  // T V_j -> out_i
  fixed_flush<TR>(acc, sum, flag, scale, row_i, n, c0, r, tx, ty);

  if (ti != tj) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
    tile_product<TR>(acc, s.k, s.vb, tx, ty, true);  // T^T V_i -> out_j
    fixed_flush<TR>(acc, sum, flag, scale, row_j, n, c0, r, tx, ty);
  }
}

// out = sum / 2^e_col, or NaN in a flagged column.
__global__ void __launch_bounds__(THREADS)
    sym_finish_kernel(const long long* __restrict__ sum, const unsigned int* __restrict__ flag,
                      const double* __restrict__ scale, float* __restrict__ out,
                      long long total, int r) {
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    const int col = (int)(idx % r);
    out[idx] = flag[col] ? __int_as_float(0x7fc00000)
                         : (float)((double)sum[idx] / scale[col]);
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
size_t gm_smem_bytes(int r, int d, int symmetric) {
  return smem_bytes(16 * column_tiles(r), d, symmetric != 0);
}

// out (n x r) = K(x1, x2) @ v; x1 (n x d), x2 (m x d), v (m x r), all
// contiguous fp32 on the device. Returns cudaGetLastError() after the launch.
int gm_matvec_full(const float* x1, const float* x2, const float* v, float* out,
                   const int* prog, int n_instr, const float* coef, int n_coef, int n, int m,
                   int d, int r, int need_l2, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || m < 1 || d < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  const int tr = column_tiles(r);
  const dim3 grid((n + TILE - 1) / TILE, (r + 16 * tr - 1) / (16 * tr));
  const size_t smem = smem_bytes(16 * tr, d, false);
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

// out (n x r) = K(x, x) @ v from the upper-triangle tiles, bitwise the same
// on every run. Scratch from the caller: sum (n x r int64, zeroed), flag (r
// int32, 1 where a column's bound is not finite, else 0) and scale (r
// doubles, 2^e_c). Two launches: the sweep into sum, then the finishing
// pass into out. Returns the first launch error, else cudaGetLastError().
int gm_matvec_sym(const float* x, const float* v, float* out, void* sum, unsigned int* flag,
                  const double* scale, const int* prog, int n_instr, const float* coef,
                  int n_coef, int n, int d, int r, int need_l2, void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || d < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  unsigned long long* acc = static_cast<unsigned long long*>(sum);
  const int p = (n + TILE - 1) / TILE;
  const long long tiles = (long long)p * (p + 1) / 2;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tr = column_tiles(r);
  const dim3 grid((unsigned)tiles, (r + 16 * tr - 1) / (16 * tr));
  const size_t smem = smem_bytes(16 * tr, d, true);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define GM_LAUNCH_SYM(TRV)                                                                \
  case TRV:                                                                               \
    err = prepare(matvec_sym_kernel<TRV>, smem);                                          \
    if (err != cudaSuccess) return (int)err;                                              \
    matvec_sym_kernel<TRV><<<grid, THREADS, smem, st>>>(x, v, acc, flag, scale, prog,     \
                                                         n_instr, coef, n_coef, n, d, r, p, \
                                                         need_l2);                        \
    break;
  switch (tr) {
    GM_LAUNCH_SYM(1)
    GM_LAUNCH_SYM(2)
    GM_LAUNCH_SYM(3)
    GM_LAUNCH_SYM(4)
    GM_LAUNCH_SYM(5)
    GM_LAUNCH_SYM(6)
    GM_LAUNCH_SYM(7)
    GM_LAUNCH_SYM(8)
  }
#undef GM_LAUNCH_SYM
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)n * r;
  const long long blocks = (total + THREADS - 1) / THREADS;
  sym_finish_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
      static_cast<const long long*>(sum), flag, scale, out, total, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
