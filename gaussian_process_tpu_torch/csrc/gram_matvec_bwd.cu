// Backward sweep of the fused kernel matvec for NVIDIA Hopper (sm_90a).
//
// For L = <ct, K(x1, x2) V> it returns dL/dcoef, the gradient with respect to
// the coefficient vector of the kernel's postfix program, and optionally
// dL/dx1, without ever materialising K. The coefficients are differentiable
// functions of the hyperparameters on the torch side, so autograd carries
// dL/dcoef back to every params tensor; dL/dx2 is a second launch with the
// roles swapped (x2, x1, ct, V), as in the JAX package.
//
// Replaces the Pallas TPU kernel _matvec_bwd_sweep of the JAX package's
// ops/pallas/kernel_ops.py (called from _matvec_core_bwd).
//
// What it computes, per entry (i, j) of the n x m grid:
//   G_ij       = sum_c ct_ic V_jc                       (the TPU kernel's dK)
//   dcoef[k]  += G_ij dk(sq_ij, l2_ij)/dcoef_k
//   dx1[i]    += G_ij dk/dsq 2 (a_i - b_j)             (when want_dx)
// with a, b the centred coordinates and sq the direct fp32 sum of squared
// differences, as in the forward kernels.
//
// What bounds it on this card. A full sweep evaluates n m entries (1.05e10
// at n = m = 102400), each with one transcendental, its hand-written leaf
// derivatives and an r-term dot for G; unlike the forward there is no
// symmetric halving. The SFU and the fp32 pipe bound it; x, V and ct are a
// few MB and stay in L2.
//
// What the design does about it:
//   * One block owns 64 rows of x1 and loops over every 64-row tile of x2
//     (the loop takes the place of the TPU's sequential grid axis), so its
//     rows of dx1 are written once, with no atomics.
//   * G is formed per tile from ct and V column chunks of 32 in shared
//     memory; each thread owns one column b and 16 rows of the tile.
//   * The reverse pass through the postfix program is written out by hand
//     (tree_grad in gram_matvec_common.cuh, shared with the symmetric
//     sweep). A single-leaf program (RBF, Matern, ...) takes a path with
//     its 4 coefficient accumulators in registers (leaf_grad); a tree of up
//     to MAX_BWD_INSTR instructions keeps its per-instruction values in
//     local memory.
//   * dx1 = 2 sum_j G_ij dk/dsq (a_i - b_j) is a second pass over a shared
//     64 x 64 tile of G dk/dsq, one output (row, dim) per thread, summed in
//     the direct (a - b) form so no cancellation enters.
//   * Coincident points (sq = 0): the pair adds nothing to dx1 (see
//     leaf_grad); the coefficient gradient stays finite there.
//
// Precision of the reductions: each entry's products are fp32; a thread sums
// its 16 entries of a tile in fp32, then adds that to a float64 accumulator
// over all tiles; the block reduces its 256 threads in float64 and writes
// one float64 partial per coefficient; torch sums the partials over blocks
// in float64. dx1 is accumulated in fp32 (64-term tile sums, then a running
// sum over tiles).
// Simple SIMT fp32 code. The wrapper sends a same-set call that wants no dx
// (a training step's) to the symmetric sweep, gram_matvec_bwd_sym.cuh; this
// one takes cross-set calls and those that want dx1.

#include "gram_matvec_common.cuh"

namespace {

constexpr int RC = 32;                       // ct / V columns per chunk of the G product
constexpr int RC_LD = RC + 1;                // padded row: column reads are conflict-free
constexpr int EPT = TILE * TILE / THREADS;   // entries per thread per tile (16)
constexpr int ROW_STEP = THREADS / TILE;     // a thread's rows are a0, a0 + 4, ...

size_t bwd_smem_bytes(int d) {
  return sizeof(double) * THREADS +
         sizeof(float) * (size_t)(MAX_COEF + TILE * KS_LD + 2 * TILE * RC_LD + 3 * TILE * d) +
         sizeof(int) * (size_t)(2 * MAX_INSTR + 2 * MAX_BWD_INSTR);
}

// columns [c0, c0 + RC) of rows [row0, row0 + TILE) of src (rows x r) into
// dst (TILE x RC_LD); entries past the edges are zero.
__device__ __forceinline__ void load_cols(float* dst, const float* src, int row0, int rows,
                                          int c0, int r) {
  for (int idx = threadIdx.x; idx < TILE * RC; idx += THREADS) {
    const int rr = idx / RC, cc = idx - rr * RC;
    const int row = row0 + rr, col = c0 + cc;
    dst[rr * RC_LD + cc] = (row < rows && col < r) ? src[(size_t)row * r + col] : 0.0f;
  }
}

// NC: coefficient accumulators per thread; TREE: the program has more than
// one instruction (else its single leaf reads coefficients 0..3).
template <int NC, bool TREE>
__global__ void __launch_bounds__(THREADS)
    matvec_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                      const float* __restrict__ v, const float* __restrict__ ct,
                      double* __restrict__ dcoef_part, float* __restrict__ dx1,
                      const int* __restrict__ prog, int n_instr,
                      const float* __restrict__ coef, int n_coef, int n, int m, int d, int r,
                      int need_l2, int want_dx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);       // THREADS
  float* s_coef = reinterpret_cast<float*>(red + THREADS);  // MAX_COEF
  float* gs = s_coef + MAX_COEF;                            // TILE x KS_LD: G dk/dsq
  float* cts = gs + TILE * KS_LD;                           // TILE x RC_LD
  float* vs = cts + TILE * RC_LD;                           // TILE x RC_LD
  float* xa = vs + TILE * RC_LD;                            // TILE x d (this block's x1 rows)
  float* xbt = xa + TILE * d;                               // d x TILE (x2 tile, transposed)
  float* dxs = xbt + TILE * d;                              // TILE x d
  int* s_prog = reinterpret_cast<int*>(dxs + TILE * d);     // 2 MAX_INSTR
  int* kid = s_prog + 2 * MAX_INSTR;                        // 2 MAX_BWD_INSTR

  const int t = threadIdx.x;
  const int b = t % TILE;   // this thread's column of every tile
  const int a0 = t / TILE;  // and its rows a0 + ROW_STEP e, e < EPT
  const int row0 = blockIdx.x * TILE;

  load_program(s_coef, s_prog, prog, n_instr, coef, n_coef);
  load_x(xa, x1, row0, n, d, false);
  for (int i = t; i < TILE * d; i += THREADS) dxs[i] = 0.0f;
  __syncthreads();
  if (TREE && t == 0) program_kids(s_prog, n_instr, kid);  // operands of each instruction

  double dacc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) dacc[j] = 0.0;

  for (int col0 = 0; col0 < m; col0 += TILE) {
    __syncthreads();  // the previous tile's readers of xbt and gs are done
    load_x(xbt, x2, col0, m, d, true);

    float g[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) g[e] = 0.0f;
    for (int c0 = 0; c0 < r; c0 += RC) {
      if (c0 > 0) __syncthreads();  // readers of the previous chunk are done
      load_cols(cts, ct, row0, n, c0, r);
      load_cols(vs, v, col0, m, c0, r);
      __syncthreads();
      const int cn = min(RC, r - c0);
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        const float vb = vs[b * RC_LD + c];
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          g[e] = fmaf(cts[(a0 + ROW_STEP * e) * RC_LD + c], vb, g[e]);
      }
    }

    float tacc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) tacc[j] = 0.0f;
    const bool col_ok = col0 + b < m;
#pragma unroll 1
    for (int e = 0; e < EPT; ++e) {
      const int a = a0 + ROW_STEP * e;
      float gsq = 0.0f;
      if (col_ok && row0 + a < n) {
        float sq = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = xa[a * d + k] - xbt[k * TILE + b];
          sq = fmaf(diff, diff, sq);
        }
        const float l2 = need_l2 ? sqrtf(sq) : 0.0f;
        if constexpr (TREE) {
          gsq = tree_grad(s_prog, kid, s_coef, n_instr, sq, l2, g[e], tacc);
        } else {
          float kv, dc[LEAF_COEF], dsq;
          leaf_grad(s_prog[0], s_coef + s_prog[1], sq, l2, kv, dc, dsq);
#pragma unroll
          for (int j = 0; j < LEAF_COEF; ++j) tacc[j] = fmaf(g[e], dc[j], tacc[j]);
          gsq = g[e] * dsq;
        }
      }
      gs[a * KS_LD + b] = gsq;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) dacc[j] += (double)tacc[j];

    if (want_dx) {
      __syncthreads();  // the G dk/dsq tile is complete
      for (int o = t; o < TILE * d; o += THREADS) {
        const int a = o / d, k = o - a * d;
        const float xk = xa[o];
        float s = 0.0f;
#pragma unroll 8
        for (int bb = 0; bb < TILE; ++bb)
          s = fmaf(gs[a * KS_LD + bb], xk - xbt[k * TILE + bb], s);
        dxs[o] += s;  // each (row, dim) has one owner thread
      }
    }
  }

  __syncthreads();
  if (want_dx) {
    for (int o = t; o < TILE * d; o += THREADS) {
      const int row = row0 + o / d;
      if (row < n) dx1[(size_t)row0 * d + o] = 2.0f * dxs[o];
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j >= n_coef) break;  // uniform across the block
    red[t] = dacc[j];
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (t < s) red[t] += red[t + s];
      __syncthreads();
    }
    if (t == 0) dcoef_part[(size_t)blockIdx.x * n_coef + j] = red[0];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of the backward sweep needs.
size_t gm_bwd_smem_bytes(int d) { return bwd_smem_bytes(d); }

// For L = <ct, K(x1, x2) v>: dcoef_part (ceil(n / 64) x n_coef, float64)
// receives one partial of dL/dcoef per block (the caller sums the rows), and
// dx1 (n x d) receives dL/dx1 when want_dx != 0. x1 (n x d), x2 (m x d),
// v (m x r), ct (n x r): contiguous fp32 on the device. Returns
// cudaGetLastError() after the launch.
int gm_matvec_bwd(const float* x1, const float* x2, const float* v, const float* ct,
                  double* dcoef_part, float* dx1, const int* prog, int n_instr,
                  const float* coef, int n_coef, int n, int m, int d, int r, int need_l2,
                  int want_dx, void* stream) {
  if (n_instr < 1 || n_instr > MAX_BWD_INSTR || n_coef < 1 || n_coef > MAX_BWD_COEF ||
      n < 1 || m < 1 || d < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  if (n_instr == 1 && n_coef > LEAF_COEF) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + TILE - 1) / TILE);
  const size_t smem = bwd_smem_bytes(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_instr == 1) {
    err = prepare(matvec_bwd_kernel<LEAF_COEF, false>, smem);
    if (err != cudaSuccess) return (int)err;
    matvec_bwd_kernel<LEAF_COEF, false><<<grid, THREADS, smem, st>>>(
        x1, x2, v, ct, dcoef_part, dx1, prog, n_instr, coef, n_coef, n, m, d, r, need_l2,
        want_dx);
  } else {
    err = prepare(matvec_bwd_kernel<MAX_BWD_COEF, true>, smem);
    if (err != cudaSuccess) return (int)err;
    matvec_bwd_kernel<MAX_BWD_COEF, true><<<grid, THREADS, smem, st>>>(
        x1, x2, v, ct, dcoef_part, dx1, prog, n_instr, coef, n_coef, n, m, d, r, need_l2,
        want_dx);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
