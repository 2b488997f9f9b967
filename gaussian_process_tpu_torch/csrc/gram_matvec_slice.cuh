// The sliced layout of the matrix-free sweeps, which takes any d: K2, K3 and
// K4's two sweeps at D = X_SLICED. Past the widths at which a sweep holds x
// in registers (a compiled leaf) or at full width in shared memory (the
// interpreter, d <= 8), x is first
// prescaled into a copy whose rows are padded to whole blocks and whose
// coordinates are padded with zeros to whole slices of X_SLICE; the sweep
// then stages the rows it needs a slice at a time, with cp.async and
// double buffers, and each thread keeps the squared-distance sums of the
// entries it owns in registers across the slices, then evaluates the leaf
// or the interpreter on the whole sum. The sum is the direct one,
// sum (a - b)^2 in coordinate order, with the full-width loop's bits (a
// zero coordinate adds fma(0, 0, sq) = sq), so a coincident pair still
// meets sq = 0 exactly. Shared memory no longer grows with d.

#pragma once

#include "gram_matvec_common.cuh"

namespace {

constexpr int X_SLICED = -1;             // a sweep's D for the sliced layout
constexpr int X_SLICE = 32;              // coordinates of a slice
constexpr int X_SLICE_LD = X_SLICE + 4;  // padded row: 16-byte reads by 8 rows hit 8 bank groups

// d padded to whole slices: the sliced layout's row width.
__host__ __device__ inline int slice_width(int d) {
  return (d + X_SLICE - 1) / X_SLICE * X_SLICE;
}

// xs (rows_pad x dp) = x (rows x d) times the x scale of the route leaf
// (leaf_x_scale; 1 for the interpreter), zero past rows and past d: the
// sliced layout's copy of x, by the product the sweeps' staging passes use
// for x2, so that both sides of a coincident pair round alike.
__global__ void __launch_bounds__(THREADS)
    prescale_rows_kernel(const float* __restrict__ x, const int* __restrict__ prog,
                         const float* __restrict__ coef, int leaf, float* __restrict__ xs,
                         int rows, int rows_pad, int d, int dp) {
  float s = 1.0f;
  if (leaf == OP_RBF)
    s = leaf_x_scale<OP_RBF>(coef[prog[1] + 1]);
  else if (leaf != 0)  // every Matern scales x by its c1
    s = leaf_x_scale<OP_MATERN12>(coef[prog[1] + 1]);
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < (size_t)rows_pad * dp;
       e += step) {
    const int row = (int)(e / dp), k = (int)(e % dp);
    xs[e] = (row < rows && k < d) ? s * x[(size_t)row * d + k] : 0.0f;
  }
}

cudaError_t prescale_rows(const float* x, const int* prog, const float* coef, int leaf, float* xs,
                          int rows, int rows_pad, int d, cudaStream_t st) {
  const int dp = slice_width(d);
  const size_t want = ((size_t)rows_pad * dp + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  prescale_rows_kernel<<<blocks, THREADS, 0, st>>>(x, prog, coef, leaf, xs, rows, rows_pad, d,
                                                   dp);
  return cudaGetLastError();
}

// One step of the sliced layout: rows [ra, ra + RA) of xa, then rows
// [rb, rb + RB) of xb (both of row width dp), coordinates
// [k0, k0 + X_SLICE), into dst (RA + RB rows of X_SLICE_LD floats) by
// cp.async from the whole block; the caller commits.
template <int RA, int RB>
__device__ __forceinline__ void slice_rows(float* dst, const float* xa, int ra, const float* xb,
                                           int rb, int dp, int k0) {
  constexpr int Q = X_SLICE / 4;
  for (int e = threadIdx.x; e < (RA + RB) * Q; e += THREADS) {
    const int rr = e / Q, q = e - rr * Q;
    const float* src = rr < RA ? xa + (size_t)(ra + rr) * dp : xb + (size_t)(rb + rr - RA) * dp;
    cp_async16(dst + rr * X_SLICE_LD + 4 * q, src + k0 + 4 * q);
  }
}

// sq = fma(a_k - b_k, a_k - b_k, sq) for the four coordinates of a and b,
// in order
__device__ __forceinline__ void sq_add4(float& sq, const float4& a, const float4& b) {
  float u = a.x - b.x;
  sq = fmaf(u, u, sq);
  u = a.y - b.y;
  sq = fmaf(u, u, sq);
  u = a.z - b.z;
  sq = fmaf(u, u, sq);
  u = a.w - b.w;
  sq = fmaf(u, u, sq);
}

}  // namespace
