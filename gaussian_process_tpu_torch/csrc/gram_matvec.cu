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
//     are added with atomicAdd into a zeroed fp32 output. The summation
//     order therefore varies from run to run at fp32 rounding level.
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Opcodes: keep in sync with gaussian_process_tpu_torch/ops/cuda/kernel_ops.py.
constexpr int OP_ZERO = 0;
constexpr int OP_RBF = 1;               // c0 exp(c1 sq)
constexpr int OP_MATERN12 = 2;          // c0 exp(-c1 l2)
constexpr int OP_MATERN32 = 3;          // s = c1 l2: c0 (1 + s) exp(-s)
constexpr int OP_MATERN52 = 4;          // s = c1 l2: c0 (1 + s + s^2/3) exp(-s)
constexpr int OP_PERIODIC = 5;          // s = sin(c0 l2): exp(c1 s^2)
constexpr int OP_DECAYED_PERIODIC = 6;  // s = sin(c2 l2): c0 exp(c1 sq + c3 s^2)
constexpr int OP_RQ = 7;                // c0 exp(c2 log1p(c1 sq))
constexpr int OP_SCALE = 8;             // top *= c0
constexpr int OP_ADD = 9;
constexpr int OP_MUL = 10;

constexpr int MAX_INSTR = 64;
constexpr int MAX_COEF = 256;
constexpr int MAX_STACK = 8;
constexpr int TILE = 64;          // x1 rows and x2 rows per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int TM = 4;             // output rows per thread (16 row groups x 4)
constexpr int KS_LD = TILE + 1;   // padded row of the K tile in shared memory
constexpr int MAX_TR = 8;         // up to 16 * 8 = 128 V columns per block

__device__ __forceinline__ float eval_leaf(int op, const float* c, float sq, float l2) {
  switch (op) {
    case OP_RBF:
      return c[0] * expf(c[1] * sq);
    case OP_MATERN12:
      return c[0] * expf(-c[1] * l2);
    case OP_MATERN32: {
      float s = c[1] * l2;
      return c[0] * (1.0f + s) * expf(-s);
    }
    case OP_MATERN52: {
      float s = c[1] * l2;
      return c[0] * (1.0f + s + s * s * (1.0f / 3.0f)) * expf(-s);
    }
    case OP_PERIODIC: {
      float s = sinf(c[0] * l2);
      return expf(c[1] * s * s);
    }
    case OP_DECAYED_PERIODIC: {
      float s = sinf(c[2] * l2);
      return c[0] * expf(c[1] * sq + c[3] * s * s);
    }
    case OP_RQ:
      return c[0] * expf(c[2] * log1pf(c[1] * sq));
    default:
      return 0.0f;
  }
}

__device__ __forceinline__ float eval_tree(const int* prog, const float* coef, int n_instr,
                                           float sq, float l2) {
  if (n_instr == 1) return eval_leaf(prog[0], coef + prog[1], sq, l2);
  float st[MAX_STACK];
  int sp = 0;
#pragma unroll 1
  for (int k = 0; k < n_instr; ++k) {
    const int op = prog[2 * k];
    const int off = prog[2 * k + 1];
    if (op == OP_ADD) {
      st[sp - 2] += st[sp - 1];
      --sp;
    } else if (op == OP_MUL) {
      st[sp - 2] *= st[sp - 1];
      --sp;
    } else if (op == OP_SCALE) {
      st[sp - 1] *= coef[off];
    } else {
      st[sp++] = eval_leaf(op, coef + off, sq, l2);
    }
  }
  return st[0];
}

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

__device__ __forceinline__ void load_program(const Smem& s, const int* prog, int n_instr,
                                             const float* coef, int n_coef) {
  for (int i = threadIdx.x; i < n_coef; i += THREADS) s.coef[i] = coef[i];
  for (int i = threadIdx.x; i < 2 * n_instr; i += THREADS) s.prog[i] = prog[i];
}

// rows [row0, row0 + TILE) of x (n x d) into dst, row-major or transposed;
// rows past n are zero.
__device__ __forceinline__ void load_x(float* dst, const float* x, int row0, int n, int d,
                                       bool transpose) {
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int rr = idx / d, k = idx - rr * d;
    const int row = row0 + rr;
    const float val = row < n ? x[(size_t)row * d + k] : 0.0f;
    if (transpose)
      dst[k * TILE + rr] = val;
    else
      dst[idx] = val;
  }
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

  load_program(s, prog, n_instr, coef, n_coef);
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

template <int TR>
__device__ __forceinline__ void atomic_flush(const float (&acc)[TM][TR], float* out,
                                             int row0, int n, int c0, int r, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < r) atomicAdd(out + (size_t)row * r + col, acc[i][j]);
    }
  }
}

// One block per upper-triangle tile (ti <= tj) of the p x p tile grid.
template <int TR>
__global__ void __launch_bounds__(THREADS)
    matvec_sym_kernel(const float* __restrict__ x, const float* __restrict__ v,
                      float* __restrict__ out, const int* __restrict__ prog, int n_instr,
                      const float* __restrict__ coef, int n_coef, int n, int d, int r, int p,
                      int need_l2) {
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

  load_program(s, prog, n_instr, coef, n_coef);
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
  atomic_flush<TR>(acc, out, row_i, n, c0, r, tx, ty);

  if (ti != tj) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
    tile_product<TR>(acc, s.k, s.vb, tx, ty, true);  // T^T V_i -> out_j
    atomic_flush<TR>(acc, out, row_j, n, c0, r, tx, ty);
  }
}

int column_tiles(int r) {  // 16-column groups a block holds, 1..MAX_TR
  int tr = (r + 15) / 16;
  return tr < 1 ? 1 : (tr > MAX_TR ? MAX_TR : tr);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

bool bad_program(int n_instr, int n_coef) {
  return n_instr < 1 || n_instr > MAX_INSTR || n_coef < 0 || n_coef > MAX_COEF;
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

// out (n x r) += K(x, x) @ v from the upper-triangle tiles; out must be
// zeroed by the caller. Returns cudaGetLastError() after the launch.
int gm_matvec_sym(const float* x, const float* v, float* out, const int* prog, int n_instr,
                  const float* coef, int n_coef, int n, int d, int r, int need_l2,
                  void* stream) {
  if (bad_program(n_instr, n_coef) || n < 1 || d < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
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
    matvec_sym_kernel<TRV><<<grid, THREADS, smem, st>>>(x, v, out, prog, n_instr, coef,   \
                                                         n_coef, n, d, r, p, need_l2);    \
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
  return (int)cudaGetLastError();
}

}  // extern "C"
